"""The port's dynamics, tracker and box geometry against the JAX package
and its float64 golden maneuvers, on the same numpy-seeded inputs, in f32
on the CPU. The autopilot teacher and the GRPO evaluator's parts are
test_torch_evaluator_town.py, _retrack.py and _reward.py.

Tolerances:
- bicycle_step and track_step against the float64 golden maneuvers of
  tests/fixtures/golden_traces.npz at tests/test_golden_traces.py's bounds
  (open loop 2 cm / 0.005 rad / 2 cm/s, closed loop 10 cm / 0.01 rad /
  10 cm/s);
- obb_overlap exactly (bools); box corners 1e-5, face normals 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.geometry.obb import _axes_from_heading as jax_axes
from rift_tpu.geometry.obb import box_corners as jax_box_corners
from rift_tpu.geometry.obb import obb_overlap as jax_obb_overlap
from rift_tpu_torch.geometry.obb import _axes_from_heading, box_corners, obb_overlap
from rift_tpu_torch.sim.dynamics import bicycle_step
from rift_tpu_torch.sim.pid import TrackerState, track_step
from torch_parity import one_torch_thread

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_traces.npz")
MANEUVERS = ["accel_cruise", "brake_stop", "lane_change", "turn"]
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def traces():
    return np.load(FIX)


@pytest.mark.parametrize("name", MANEUVERS)
def test_bicycle_step_matches_golden_open_loop(traces, name):
    pos = T(traces[f"{name}/pos"][0].astype(np.float32))
    heading = torch.tensor(float(traces[f"{name}/heading"][0]))
    speed = torch.tensor(float(traces[f"{name}/speed"][0]))
    ps, hs, vs = [], [], []
    for act in traces[f"{name}/action"].astype(np.float32):
        pos, heading, speed = bicycle_step(pos, heading, speed, T(act))
        ps.append(pos.numpy())
        hs.append(float(heading))
        vs.append(float(speed))
    # trace rows are pre-step states: row t+1 == step(row t)
    np.testing.assert_allclose(np.stack(ps)[:-1], traces[f"{name}/pos"][1:], atol=0.02)
    np.testing.assert_allclose(hs[:-1], traces[f"{name}/heading"][1:], atol=0.005)
    np.testing.assert_allclose(vs[:-1], traces[f"{name}/speed"][1:], atol=0.02)


def test_track_step_matches_golden_closed_loop(traces):
    """All four maneuvers as one batch through the tracker + bicycle."""
    stack = lambda k: T(np.stack([traces[f"{m}/{k}"] for m in MANEUVERS]).astype(np.float32))
    pos, heading, speed = stack("pos")[:, 0], stack("heading")[:, 0], stack("speed")[:, 0]
    wps = stack("waypoints")  # [B, T, H, 2]
    trk = TrackerState.zeros((len(MANEUVERS),))
    ps, hs, vs = [], [], []
    for t in range(wps.shape[1]):
        act, trk = track_step(trk, wps[:, t], speed)
        pos, heading, speed = bicycle_step(pos, heading, speed, act)
        ps.append(pos)
        hs.append(heading)
        vs.append(speed)
    ps, hs, vs = (torch.stack(x, 1).numpy() for x in (ps, hs, vs))
    for i, m in enumerate(MANEUVERS):
        np.testing.assert_allclose(ps[i, :-1], traces[f"{m}/pos"][1:], atol=0.10, err_msg=m)
        np.testing.assert_allclose(hs[i, :-1], traces[f"{m}/heading"][1:], atol=0.01, err_msg=m)
        np.testing.assert_allclose(vs[i, :-1], traces[f"{m}/speed"][1:], atol=0.10, err_msg=m)


def test_obb_overlap_matches_jax():
    r = np.random.default_rng(0)
    n = 4000
    ca = r.uniform(-6, 6, (n, 2)).astype(np.float32)
    cb = r.uniform(-6, 6, (n, 2)).astype(np.float32)
    ha, hb = (r.uniform(-np.pi, np.pi, n).astype(np.float32) for _ in range(2))
    sa, sb = (r.uniform(0.5, 5.0, (n, 2)).astype(np.float32) for _ in range(2))
    args = (ca, ha, sa, cb, hb, sb)
    ref = np.asarray(jax_obb_overlap(*map(jnp.asarray, args)))
    assert 0.1 < ref.mean() < 0.9
    np.testing.assert_array_equal(obb_overlap(*map(T, args)).numpy(), ref)
    np.testing.assert_allclose(
        box_corners(T(ca), T(ha), T(sa)).numpy(),
        np.asarray(jax_box_corners(*map(jnp.asarray, (ca, ha, sa)))), atol=1e-5,
    )
    np.testing.assert_allclose(
        _axes_from_heading(T(ha)).numpy(), np.asarray(jax_axes(jnp.asarray(ha))), atol=1e-6
    )
