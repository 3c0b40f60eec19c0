"""The port's own copies of the planner and map I/O held against the JAX
package's (``tests/test_planner.py``, ``tests/test_utils.py``): the
synthetic maps, PGM and map-YAML I/O, the Python and native A*, the live
planner's smoothed path, the binary-grid A*, Bresenham and RRT*, on the
same inputs, on the CPU.

Band: all of it is host code on the same NumPy inputs, so every output is
exactly equal (maps byte-equal, paths cell for cell, the smoothed path
float for float).
"""

import os
from pathlib import Path

import numpy as np
import pytest

from ros2_mpc_tpu.planner import global_planner as jgp
from ros2_mpc_tpu.planner.astar_py import astar_path_py as j_astar_py
from ros2_mpc_tpu.planner.native import astar_path_native as j_astar_native
from ros2_mpc_tpu.utils import pgm as jpgm
from ros2_mpc_tpu_torch.planner import global_planner as tgp
from ros2_mpc_tpu_torch.planner import native as tnative
from ros2_mpc_tpu_torch.planner.astar_py import astar_path_py as t_astar_py
from ros2_mpc_tpu_torch.utils import pgm as tpgm

ROOT = Path(__file__).resolve().parent.parent


def corridor(h=30, w=40):
    weights = np.ones((h, w), dtype=np.float32)
    weights[:, 20] = 255.0
    weights[14, 20] = 1.0
    return weights


@pytest.mark.parametrize("kind", ["indoor", "home"])
def test_synthetic_maps_byte_equal(kind):
    if kind == "indoor":
        pairs = [(tpgm.synthetic_indoor_map(), jpgm.synthetic_indoor_map())]
        pairs.append((tpgm.synthetic_indoor_map(60, 80, seed=1), jpgm.synthetic_indoor_map(60, 80, seed=1)))
        assert tpgm.DEFAULT_MAP_INFO == jpgm.DEFAULT_MAP_INFO
    else:
        pairs = [(tpgm.synthetic_home_map(), jpgm.synthetic_home_map())]
        assert tpgm.HOME_MAP_INFO == jpgm.HOME_MAP_INFO
    for got, want in pairs:
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_pgm_io_matches(tmp_path):
    img = tpgm.synthetic_indoor_map(60, 80, seed=1)
    tpgm.write_pgm(str(tmp_path / "t.pgm"), img)
    jpgm.write_pgm(str(tmp_path / "j.pgm"), img)
    assert (tmp_path / "t.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()
    np.testing.assert_array_equal(tpgm.read_pgm(str(tmp_path / "j.pgm")), img)
    (tmp_path / "a.pgm").write_text("P2\n# comment\n3 2\n255\n0 100 200\n254 205 0\n")
    np.testing.assert_array_equal(tpgm.read_pgm(str(tmp_path / "a.pgm")), jpgm.read_pgm(str(tmp_path / "a.pgm")))
    for name in ("map_synthetic", "map_home"):
        np.testing.assert_array_equal(
            tpgm.read_pgm(str(ROOT / "maps" / f"{name}.pgm")), jpgm.read_pgm(str(ROOT / "maps" / f"{name}.pgm"))
        )
        yaml_path = str(ROOT / "maps" / f"{name}.yaml")
        assert tpgm.load_map_yaml(yaml_path) == jpgm.load_map_yaml(yaml_path)


def test_python_astar_matches():
    weights = corridor()
    for start, goal in (((2, 2), (25, 35)), ((0, 0), (29, 39)), ((5, 30), (5, 2))):
        for diag in (False, True):
            np.testing.assert_array_equal(
                t_astar_py(weights, start, goal, diag), j_astar_py(weights, start, goal, diag)
            )
    blocked = np.ones((10, 10), dtype=np.float32)
    blocked[:, 5] = np.inf
    assert t_astar_py(blocked, (0, 0), (0, 9)).shape == (0, 2)
    assert t_astar_py(blocked, (0, 0), (0, 10)).shape == (0, 2)  # goal off the grid


def test_native_astar_builds_in_the_port_and_matches():
    """The port compiles the repository's native/astar.cpp into its own
    ``ros2_mpc_tpu_torch/_native/`` and finds the JAX package's native path."""
    weights = corridor()
    start, goal = (2, 2), (25, 35)
    got = tnative.astar_path_native(weights, start, goal)
    assert got is not None, "native A* library failed to build"
    assert os.path.dirname(tnative._SO) == str(ROOT / "ros2_mpc_tpu_torch" / "_native")
    np.testing.assert_array_equal(got, j_astar_native(weights, start, goal))
    assert [14, 20] in got.tolist()
    np.testing.assert_array_equal(tgp.astar_path(weights, start, goal), jgp.astar_path(weights, start, goal))


def test_astar_planner2_smoothed_path_matches():
    """The live planner on the stack's own map: the 0/255 dilated image, the
    weight remap, A* and the Savitzky-Golay rows; and a too-short path that
    passes through unsmoothed."""
    img = tpgm.synthetic_indoor_map()
    binary = np.where(img == 0, 255, 0).astype(np.uint8)
    cases = [((230, 105), (100, 145), binary), ((2, 2), (35, 30), np.zeros((40, 40))), ((5, 15), (15, 15), None)]
    wall = np.zeros((30, 30))
    wall[10, 5:25] = 1
    cases[2] = ((5, 15), (15, 15), wall)
    cases.append(((3, 3), (3, 6), np.zeros((10, 10))))
    for start, goal, image in cases:
        got = tgp.AStarPlanner2().get_path(start, goal, image)
        want = jgp.AStarPlanner2().get_path(start, goal, image)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(np.asarray(got, dtype=float), np.asarray(want, dtype=float))


def test_binary_astar_bresenham_and_rrt_match():
    grid = np.zeros((15, 15), dtype=bool)
    grid[7, 2:13] = True
    for start, goal in (((2, 7), (12, 7)), ((2, 7), (7, 5))):
        assert tgp.AstarGlobalPlanner().get_path(start, goal, grid) == jgp.AstarGlobalPlanner().get_path(
            start, goal, grid
        )
    segs = [[(0, 0), (4, 2)], [(4, 2), (-3, 7)]]
    np.testing.assert_array_equal(tgp.get_points_on_lines(segs), jgp.get_points_on_lines(segs))
    og = np.zeros((60, 60))
    og[30, 0:50] = 1
    got = tgp.RRTGlobalPlanner(og, n=300, seed=3).get_path((5, 5), (55, 5))
    np.testing.assert_array_equal(got, jgp.RRTGlobalPlanner(og, n=300, seed=3).get_path((5, 5), (55, 5)))
