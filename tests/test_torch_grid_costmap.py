"""The port's grid and costmap ops (``ros2_mpc_tpu_torch.ops.grid``,
``ops.costmap``) held against the JAX package's (``tests/test_grid.py``,
``tests/test_costmap.py``) on the same seeded NumPy inputs, on the CPU.

Bands: integer and binary grids (rasterized scans, scatters, masks, map
pixels, dilations) exactly equal; float fields (scan XY, coordinate fields,
rotations, the inflation stamp and inflated grids) within 1e-6 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu.ops import costmap as jc
from ros2_mpc_tpu.ops import grid as jg
from ros2_mpc_tpu_torch.ops import costmap as tc
from ros2_mpc_tpu_torch.ops import grid as tg

FLOAT_ATOL = 1e-6


def t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def scan(seed, n=360):
    rng = np.random.default_rng(seed)
    ranges = rng.uniform(0.1, 3.0, size=n)
    ranges[10] = np.nan
    ranges[20] = np.inf
    return ranges, float(rng.uniform(-np.pi, np.pi))


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_scan_to_occupancy_matches_jax(seed):
    ranges, rot = scan(seed)
    angles = np.array([-np.pi, np.pi])
    want = np.asarray(jg.make_scan_to_occupancy(0.05, 4.0)(jnp.asarray(ranges), jnp.asarray(angles), rot))
    got = tg.make_scan_to_occupancy(0.05, 4.0)(t(ranges), t(angles), rot)
    assert got.dtype == torch.float32 and got.shape == (80, 80)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_scan_to_xy_matches_jax():
    ranges, rot = scan(5)
    ranges[30:40] = np.nan
    angles = np.array([0.0, np.pi])
    wx, wy = jg.scan_to_xy(jnp.asarray(ranges), jnp.asarray(angles), rotation=rot)
    gx, gy = tg.scan_to_xy(t(ranges), t(angles), rotation=rot)
    assert torch.isfinite(gx).all() and torch.isfinite(gy).all()
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=FLOAT_ATOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=FLOAT_ATOL)


def test_xy_to_occupancy_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(-1.0, 3.0, size=500)
    y = rng.uniform(-1.0, 3.0, size=500)
    origin = np.array([0.1, -0.2])
    want = np.asarray(jg.make_xy_to_occupancy(0.1, 20, 25)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(origin)))
    got = tg.make_xy_to_occupancy(0.1, 20, 25)(t(x), t(y), t(origin))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 500 * 100  # some points fell outside and were dropped


def test_occupancy_xy_fields_match_jax():
    rng = np.random.default_rng(7)
    occ = np.where(rng.uniform(size=(40, 30)) > 0.8, 255.0, 0.0)
    origin = np.array([-6.25, -3.1])
    wm, wx, wy = jg.occupancy_to_xy_fields(jnp.asarray(occ), 0.05, jnp.asarray(origin))
    gm, gx, gy = tg.occupancy_to_xy_fields(t(occ), 0.05, origin)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=FLOAT_ATOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=FLOAT_ATOL)
    xs, ys = tg.convert_occ_grid_to_xy_coordinates(occ, 0.05, origin, device="cpu")
    jxs, jys = jg.convert_occ_grid_to_xy_coordinates(occ, 0.05, origin)
    assert len(xs) == len(jxs) == int((occ == 255).sum())
    np.testing.assert_allclose(xs, jxs, atol=FLOAT_ATOL)
    np.testing.assert_allclose(ys, jys, atol=FLOAT_ATOL)


@pytest.mark.parametrize("shape", [(7, 9), (80, 80)])
def test_convert_to_map_coordinates_matches_jax(shape):
    wy, wx = jg.convert_to_map_coordinates(jnp.zeros(shape), 0.05)
    gy, gx = tg.convert_to_map_coordinates(torch.zeros(shape), 0.05)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=FLOAT_ATOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=FLOAT_ATOL)


def test_rotate_and_quaternion_helpers_match_jax():
    rng = np.random.default_rng(8)
    pts = rng.uniform(-2, 2, size=(2, 50))
    np.testing.assert_allclose(
        tg.rotate_coordinates(t(pts), 0.77).numpy(),
        np.asarray(jg.rotate_coordinates(jnp.asarray(pts), 0.77)),
        atol=FLOAT_ATOL,
    )
    for yaw in (0.77, -2.5, 3.1):
        z, w = tg.quaternion_from_yaw(yaw)
        np.testing.assert_allclose([z, w], np.asarray(jg.quaternion_from_yaw(yaw)), atol=FLOAT_ATOL)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_allclose(
            tg.euler_from_quaternion(*q), [float(v) for v in jg.euler_from_quaternion(*q)], atol=FLOAT_ATOL
        )
    r, p, y = tg.euler_from_quaternion(0.0, 0.0, *tg.quaternion_from_yaw(0.77))
    np.testing.assert_allclose([r, p, y], [0.0, 0.0, 0.77], atol=FLOAT_ATOL)


def test_world_map_conversions_match_jax():
    """world_to_map's pixel, including XLA's saturating cast (NaN to 0), and
    map_to_world's world path, equal to the JAX package's."""
    shape, origin, res = (200, 300), (-4.84, -6.61), 0.05
    rng = np.random.default_rng(9)
    points = [tuple(p) for p in rng.uniform(-6, 6, size=(20, 2))] + [(np.nan, 0.0), (1e12, -1e12)]
    for wx, wy in points:
        want = np.asarray(jg.world_to_map(wx, wy, shape, origin, res))
        np.testing.assert_array_equal(tg.world_to_map(wx, wy, shape, origin, res), want)
    path = rng.integers(0, 200, size=(15, 2))
    np.testing.assert_array_equal(
        tg.map_to_world(path, shape, origin, res), jg.map_to_world(path, shape, origin, res)
    )
    assert tg.map_to_world(np.zeros((0, 2)), (10, 10), (0.0, 0.0), 0.05) is None


@pytest.mark.parametrize("c", [2, 4, 7])
def test_inflation_matrix_matches_jax(c):
    got = tc.get_inflation_matrix(c, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jc.get_inflation_matrix(c)), atol=FLOAT_ATOL)


def test_inflate_global_and_local_match_jax():
    rng = np.random.default_rng(3)
    occ = np.full((40, 50), 255.0)
    occ[rng.integers(0, 40, size=15), rng.integers(0, 50, size=15)] = 0.0
    occ[0, 0] = occ[39, 49] = 0.0
    c = 4
    jinfl, tinfl = jc.get_inflation_matrix(c), tc.get_inflation_matrix(c, device="cpu")
    want = np.asarray(jc.inflate_global(jnp.asarray(occ), jinfl, c))
    np.testing.assert_allclose(tc.inflate_global(t(occ), tinfl, c).numpy(), want, atol=FLOAT_ATOL)
    # local windows, one clamped against the grid's edge as dynamic_slice clamps it
    for pos in ((25.0, 20.0), (3.0, 38.0)):
        want = np.asarray(jc.inflate_local(jnp.asarray(occ), jinfl, c, jnp.asarray(pos), 16))
        got = tc.inflate_local(t(occ), tinfl, c, pos, 16)
        assert got.shape == (16, 16)
        np.testing.assert_allclose(got.numpy(), want, atol=FLOAT_ATOL)


@pytest.mark.parametrize("k, iters", [(10, 1), (8, 2), (3, 1), (7, 2)])
def test_dilate_matches_jax(k, iters):
    """Even kernels pad (k//2, k-1-k//2), as cv2 anchors them."""
    rng = np.random.default_rng(4)
    img = (rng.uniform(size=(30, 37)) > 0.9).astype(np.float32) * 100.0
    want = np.asarray(jc.dilate(jnp.asarray(img), k, iters))
    np.testing.assert_array_equal(tc.dilate(t(img), k, iters).numpy(), want)


def test_erode_image_and_threshold_match_jax():
    img = np.zeros((40, 30), dtype=np.float32)
    img[10, 10] = img[30, 5] = 255.0
    got = tc.erode_image(t(img), 8)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.erode_image(jnp.asarray(img), 8)))
    data = np.random.default_rng(5).integers(-1, 101, size=(12, 9))
    np.testing.assert_array_equal(tc.threshold_map_message(data), jc.threshold_map_message(data))
