"""PGM map image I/O + synthetic map generation.

The port's own copy of :mod:`ros2_mpc_tpu.utils.pgm`; PyYAML is imported
only where a map YAML is read, so the synthetic maps need no yaml.

The reference ships a cartographer-built map (maps/map_carto.pgm, trinary:
254 free / 0 occupied / 205 unknown, maps/map_carto.yaml) and loads it with
OpenCV (core/map_server.py:14-15). Here PGM P2/P5 parsing is ~40 lines of
stdlib, and a deterministic synthetic indoor map generator provides the test
asset (no binary blobs in the repo, nothing copied from the reference)."""

from __future__ import annotations

import numpy as np


def read_pgm(path: str) -> np.ndarray:
    """Read a P2 (ASCII) or P5 (binary) PGM as uint8/uint16 (H, W)."""
    with open(path, "rb") as fh:
        data = fh.read()

    # Tokenize the header, skipping '#' comments.
    tokens = []
    i = 0
    while len(tokens) < 4 and i < len(data):
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
        elif data[i : i + 1].isspace():
            i += 1
        else:
            j = i
            while j < len(data) and not data[j : j + 1].isspace() and data[j : j + 1] != b"#":
                j += 1
            tokens.append(data[i:j])
            i = j
    magic, w, h, maxval = tokens[0].decode(), int(tokens[1]), int(tokens[2]), int(tokens[3])
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    if magic == "P5":
        i += 1  # single whitespace after maxval
        img = np.frombuffer(data[i : i + w * h * dtype.itemsize], dtype=dtype, count=w * h)
    elif magic == "P2":
        img = np.array(data[i:].split()[: w * h], dtype=int).astype(dtype)
    else:
        raise ValueError(f"unsupported PGM magic {magic!r}")
    return img.reshape(h, w)


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write uint8 (H, W) as binary P5."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(f"P5\n{w} {h}\n255\n".encode())
        fh.write(img.tobytes())


def load_map_yaml(path: str) -> dict:
    """map_server-style map metadata (maps/map_carto.yaml format)."""
    import yaml

    with open(path, "r") as fh:
        meta = yaml.safe_load(fh)
    return {
        "resolution": float(meta["resolution"]),
        "origin": [float(meta["origin"][0]), float(meta["origin"][1])],
        "image": meta.get("image"),
    }


def synthetic_indoor_map(h: int = 250, w: int = 250, seed: int = 7) -> np.ndarray:
    """Deterministic trinary map in the cartographer convention the reference
    map uses (254 free, 0 occupied, 205 unknown): an outer wall, a few rooms
    with door gaps, and scattered pillars."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 205, dtype=np.uint8)  # unknown border region
    img[10 : h - 10, 10 : w - 10] = 254  # free interior

    # outer walls
    img[10:12, 10 : w - 10] = 0
    img[h - 12 : h - 10, 10 : w - 10] = 0
    img[10 : h - 10, 10:12] = 0
    img[10 : h - 10, w - 12 : w - 10] = 0

    # interior walls with door gaps
    mid_r, mid_c = h // 2, w // 2
    img[mid_r : mid_r + 2, 10 : w - 10] = 0
    img[mid_r : mid_r + 2, mid_c - 14 : mid_c + 14] = 254  # central door
    img[10:mid_r, mid_c : mid_c + 2] = 0
    img[mid_r - 40 : mid_r - 16, mid_c : mid_c + 2] = 254  # upper door

    # pillars
    for _ in range(6):
        r = int(rng.integers(25, h - 30))
        c = int(rng.integers(25, w - 30))
        if abs(r - mid_r) < 8:  # keep doors clear
            continue
        img[r : r + 4, c : c + 4] = 0
    return img


def synthetic_home_map(h: int = 314, w: int = 224, seed: int = 11) -> np.ndarray:
    """A real-scale (224 x 314 @ 0.05 m — the reference carto map's
    dimensions, maps/map_carto.yaml:1-7) cartographer-style apartment:
    four rooms around a cross of interior walls with offset doorways, an
    irregular unknown fringe outside the outer wall, scan-shadow speckle,
    and ragged (sensor-noise) wall edges. Deterministic; generated, never
    copied — this is the repo's self-shipped stand-in for the reference's
    real-world SLAM asset, so the carto-class closed-loop tests run from
    repo assets alone."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 205, dtype=np.uint8)
    img[12:302, 12:212] = 254

    def wall_h(r, c0, c1):
        img[r : r + 2, c0:c1] = 0

    def wall_v(c, r0, r1):
        img[r0:r1, c : c + 2] = 0

    # outer walls
    wall_h(12, 12, 212)
    wall_h(300, 12, 212)
    wall_v(12, 12, 302)
    wall_v(210, 12, 302)
    # horizontal divider with two doorways (24 cells = 1.2 m wide — the
    # planner's double 8x8 dilation closes ~0.7 m, leaving a 0.5 m corridor)
    wall_h(150, 12, 212)
    # bottom vertical divider + top vertical divider, one doorway each
    wall_v(110, 150, 302)
    wall_v(80, 12, 152)
    doorways = (
        (slice(150, 152), slice(56, 80)),
        (slice(150, 152), slice(146, 170)),
        (slice(206, 230), slice(110, 112)),
        (slice(56, 80), slice(80, 82)),
    )
    for rs, cs in doorways:
        img[rs, cs] = 254
    # furniture/pillars away from the doorways
    for r, c in ((40, 160), (110, 30), (200, 40), (260, 160), (80, 120)):
        img[r : r + 5, c : c + 5] = 0

    # cartographer artifacts: ragged wall edges (flip ~15% of cells adjacent
    # to walls to occupied), scan-shadow unknown speckle in the interior
    occ = img == 0
    frontier = np.zeros_like(occ)
    frontier[1:, :] |= occ[:-1, :]
    frontier[:-1, :] |= occ[1:, :]
    frontier[:, 1:] |= occ[:, :-1]
    frontier[:, :-1] |= occ[:, 1:]
    frontier &= img == 254
    jitter = frontier & (rng.random(img.shape) < 0.15)
    img[jitter] = 0
    free = img == 254
    speckle = free & (rng.random(img.shape) < 0.003)
    img[speckle] = 205
    # the sensor-noise jitter must not narrow the doorways below what the
    # planner's dilation can pass — re-carve them clean
    for rs, cs in doorways:
        img[rs, cs] = 254
    return img


DEFAULT_MAP_INFO = {"resolution": 0.05, "origin": [-6.25, -6.25]}
HOME_MAP_INFO = {"resolution": 0.05, "origin": [-5.6, -7.85]}
