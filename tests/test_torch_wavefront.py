"""The port's wavefront planner (``ros2_mpc_tpu_torch.planner.wavefront``)
held against the JAX package's (tests/test_planner.py:109-126) on the CPU.

Band: bit-equal. The weights are integers in float32 and the relaxation is
min and add, exact in float32, and the port's sweep count equals
``lax.while_loop``'s, truncated by ``max_sweeps`` or not; so the fields,
the sweep counts and the extracted paths must be equal. The field's value at
the start equals the A* path's cost (rtol 1e-5, tests/test_planner.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu.planner import wavefront as jwf
from ros2_mpc_tpu_torch.planner import astar_path
from ros2_mpc_tpu_torch.planner import wavefront as wf


def make_corridor(h=30, w=40):
    """tests/test_planner.py's free grid with a wall and one gap."""
    weights = np.ones((h, w), dtype=np.float32)
    weights[:, 20] = 255.0
    weights[14, 20] = 1.0
    return weights


def random_weights(seed, shape=(33, 47)):
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 6, size=shape).astype(np.float32)
    w[rng.random(shape) < 0.25] = 255.0
    return w


def jax_sweeps(w, goal, max_sweeps):
    """lax.while_loop's sweep count, by relaxing in numpy the way it does."""
    H, W = w.shape
    n = max_sweeps if max_sweeps > 0 else H + W
    d0 = np.full((H, W), np.float32(1e9), np.float32)
    d0[goal] = 0.0

    def relax(d):
        big = np.float32(1e9)
        up = np.pad(d[1:], ((0, 1), (0, 0)), constant_values=big)
        down = np.pad(d[:-1], ((1, 0), (0, 0)), constant_values=big)
        left = np.pad(d[:, 1:], ((0, 0), (0, 1)), constant_values=big)
        right = np.pad(d[:, :-1], ((0, 0), (1, 0)), constant_values=big)
        return np.minimum(d, np.minimum(np.minimum(up, down), np.minimum(left, right)) + w)

    d, prev, i = relax(d0), d0, 1
    while i < n and (d != prev).any():
        d, prev, i = relax(d), d, i + 1
    return i


@pytest.mark.parametrize("max_sweeps", [0, 7, 40])
@pytest.mark.parametrize("case", ["corridor", "random0", "random1"])
def test_distance_field_bit_equal_to_jax(case, max_sweeps):
    w = make_corridor() if case == "corridor" else random_weights(int(case[-1]))
    goal = (25, 35) if case == "corridor" else (int(w.shape[0] * 0.7), int(w.shape[1] * 0.2))
    want = np.asarray(jwf.distance_field(jnp.asarray(w), jnp.array(goal), max_sweeps))
    got = wf.distance_field(torch.from_numpy(w), goal, max_sweeps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    H, W = w.shape
    d0 = wf.goal_fields((H, W), goal, "cpu")[0]
    relaxed, sweeps = wf.relax(d0, torch.from_numpy(w), max_sweeps if max_sweeps > 0 else H + W)
    assert torch.equal(relaxed, got)
    assert int(sweeps) == jax_sweeps(w, goal, max_sweeps)
    if max_sweeps == 7:  # truncated: still the goal's neighbourhood only
        assert (want >= wf._BIG).any()


def test_distance_field_start_value_is_the_astar_cost():
    w = make_corridor()
    start, goal = (2, 2), (25, 35)
    field = wf.distance_field(torch.from_numpy(w), goal)
    path = astar_path(w, start, goal)
    cost = sum(w[r, c] for r, c in path[1:])
    np.testing.assert_allclose(float(field[start]), cost, rtol=1e-5)
    got = wf.extract_path(field, start)
    want = jwf.extract_path(np.asarray(jwf.distance_field(jnp.asarray(w), jnp.array(goal))), start)
    np.testing.assert_array_equal(got, want)
    assert tuple(got[0]) == start and tuple(got[-1]) == goal
    assert wf.extract_path(field, start, max_len=5).shape == (6, 2)
    walled = w.copy()
    walled[14, 20] = 255.0
    walled[:, 19:22] = 1e9  # no way through
    assert wf.extract_path(wf.distance_field(torch.from_numpy(walled), goal), start).shape == (0, 2)


def test_batched_distance_fields_equal_to_jax():
    w = random_weights(2)
    goals = np.array([[0, 0], [32, 46], [10, 5], [20, 30]])
    want = np.asarray(jwf.batched_distance_fields(jnp.asarray(w), jnp.asarray(goals)))
    got = wf.batched_distance_fields(torch.from_numpy(w), torch.from_numpy(goals))
    assert got.shape == (4, 33, 47)
    np.testing.assert_array_equal(got.numpy(), want)
    for g, goal in enumerate(goals):  # one loop over the stack = one field per goal
        np.testing.assert_array_equal(got[g].numpy(), wf.distance_field(torch.from_numpy(w), tuple(goal)).numpy())
