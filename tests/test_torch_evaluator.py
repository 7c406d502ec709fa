"""The port's dynamics, tracker and box geometry against the JAX package
and its float64 golden maneuvers, on the same numpy-seeded inputs, in f32
on the CPU. Two maneuvers' open loop and box geometry are
test_torch_evaluator_golden.py; the autopilot teacher and the GRPO
evaluator's parts test_torch_evaluator_town.py, _retrack.py and
_reward.py (files of at most three tests, which the tier-1 run's loadfile
scheduler hands out after its long pole).

Tolerances:
- bicycle_step and track_step against the float64 golden maneuvers of
  tests/fixtures/golden_traces.npz at tests/test_golden_traces.py's bounds
  (open loop 2 cm / 0.005 rad / 2 cm/s, closed loop 10 cm / 0.01 rad /
  10 cm/s);
- obb_overlap exactly (bools); box corners 1e-5, face normals 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from rift_tpu_torch.sim.dynamics import bicycle_step
from rift_tpu_torch.sim.pid import TrackerState, track_step
from torch_parity import one_torch_thread

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_traces.npz")
MANEUVERS = ["accel_cruise", "brake_stop", "lane_change", "turn"]
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def traces():
    return np.load(FIX)


def bicycle_matches_golden(traces, name):
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


@pytest.mark.parametrize("name", MANEUVERS[:2])
def test_bicycle_step_matches_golden_open_loop(traces, name):
    bicycle_matches_golden(traces, name)


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
