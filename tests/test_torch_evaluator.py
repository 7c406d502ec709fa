"""The port's dynamics, tracker, geometry, autopilot teacher and GRPO
evaluator against the JAX package, on the same numpy-seeded inputs, in f32
on the CPU (where the retrack and refline wrappers run their plain
versions).

Tolerances:
- bicycle_step and track_step against the float64 golden maneuvers of
  tests/fixtures/golden_traces.npz at tests/test_golden_traces.py's bounds
  (open loop 2 cm / 0.005 rad / 2 cm/s, closed loop 10 cm / 0.01 rad /
  10 cm/s);
- obb_overlap exactly (bools); box corners 1e-5, face normals 1e-6;
- lane_follow_waypoints 1e-4 m and autopilot_steady_speed 1e-5 m/s (f32
  projections over a 100 m town);
- ref_line_matrices 1e-4 against both the XLA path and the Pallas kernel
  in interpret mode (test_evaluator.py's bound), nearest indices exactly;
- rollout_candidates 2e-3 against the Pallas kernel in interpret mode and
  against the lax.scan (test_evaluator.py's bound: the Pallas kernel's
  Taylor atan and re-found closest points move a path by millimetres);
  the scan is compared over a 12-frame horizon, whose compile takes
  seconds where the 40-frame one takes a minute;
- forecast_neighbors, derive_kinematics and dense_reward 1e-5 (1e-4 for
  the yaw acceleration, three chained differences at dt = 0.1);
- grpo_advantage_batched at B=2 over a 20-frame horizon: returns 1e-3,
  advantages 1e-3, the valid mask exactly. The 40-frame evaluator is held
  against the JAX package through the train act step in
  test_torch_train.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.geometry.obb import _axes_from_heading as jax_axes
from rift_tpu.geometry.obb import box_corners as jax_box_corners
from rift_tpu.geometry.obb import obb_overlap as jax_obb_overlap
from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.map import make_straight_town as jax_straight_town
from rift_tpu.ops.refline import refline_matrices_pallas
from rift_tpu.ops.retrack import retrack_rollout_pallas
from rift_tpu.rl import evaluator as jev
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.sim.autopilot import lane_follow_waypoints as jax_lane_follow
from rift_tpu.sim.world import autopilot_steady_speed as jax_steady_speed
from rift_tpu_torch.geometry.obb import _axes_from_heading, box_corners, obb_overlap
from rift_tpu_torch.map import make_straight_town
from rift_tpu_torch.ops.refline import refline_matrices_ref
from rift_tpu_torch.ops.retrack import retrack_rollout_ref
from rift_tpu_torch.rl import evaluator as tev
from rift_tpu_torch.sim.autopilot import lane_follow_waypoints
from rift_tpu_torch.sim.dynamics import bicycle_step
from rift_tpu_torch.sim.pid import TrackerState, track_step
from rift_tpu_torch.sim.world import autopilot_steady_speed
from torch_parity import map_from_jax, one_torch_thread, state_from_jax

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_traces.npz")
MANEUVERS = ["accel_cruise", "brake_stop", "lane_change", "turn"]
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def traces():
    return np.load(FIX)


@pytest.fixture(scope="module")
def town():
    """The grid town of the planner tests, S=2 scenarios of A=6 agents,
    every background vehicle awake, with seeded speeds and ticks so that
    leaders, lights and junction yields all take part."""
    jmap = jax_grid_town(blocks=1, num_lanes=2)
    env = JaxTrafficEnv(jmap, num_scenarios=2, num_agents=6, max_cbvs=2, seed=3)
    jstate, _, _ = env.reset()
    jstate = jax_wake(jstate)
    r = np.random.default_rng(11)
    jstate = jstate.replace(
        speed=jnp.asarray(r.uniform(0.0, 12.0, jstate.speed.shape).astype(np.float32)),
        tick=jnp.asarray([95, 230], jnp.int32),
        stopped_at_stop=jnp.asarray(r.random(jstate.alive.shape) < 0.5),
    )
    return dict(
        jmap=jmap, jstate=jstate,
        tmap=map_from_jax(jmap),  # equal to the port's grid town, bit for bit (test_torch_map)
        state=state_from_jax(jstate),
    )


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


def test_lane_follow_waypoints_matches_jax(town):
    js, ts = town["jstate"], town["state"]
    r = np.random.default_rng(2)
    # a per-agent spacing and a per-point speed profile over 8 chained lanes
    for spacing, kw in (
        (r.uniform(0.1, 1.5, js.speed.shape), {}),
        (r.uniform(0.1, 1.5, js.speed.shape + (80,)), dict(num_points=80, n_chain=8)),
    ):
        spacing = spacing.astype(np.float32)
        ref = jax_lane_follow(
            town["jmap"], js.lane, js.pos, js.heading, js.bv_branch_bits,
            jnp.asarray(spacing), **kw,
        )
        got = lane_follow_waypoints(
            town["tmap"], ts.lane, ts.pos, ts.heading, ts.bv_branch_bits, T(spacing), **kw
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_autopilot_steady_speed_matches_jax(town):
    ref = np.asarray(jax.jit(jax_steady_speed)(town["jmap"], town["jstate"]))
    got = autopilot_steady_speed(town["tmap"], town["state"]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_ref_line_matrices_matches_jax():
    """test_evaluator.py:117's case."""
    rng = np.random.default_rng(5)
    R, M, Tn, Nr = 3, 4, 10, 17
    cand_pos = rng.normal(0, 20, (R, M, Tn, 2)).astype(np.float32)
    cand_heading = rng.uniform(-np.pi, np.pi, (R, M, Tn)).astype(np.float32)
    ref_pos = rng.normal(0, 20, (R, Nr, 2)).astype(np.float32)
    ref_heading = rng.uniform(-np.pi, np.pi, (R, Nr)).astype(np.float32)
    ref_valid = rng.random((R, Nr)) > 0.2
    ref_valid[:, 0] = True
    dd, da = jev.ref_line_matrices(
        *map(jnp.asarray, (cand_pos, cand_heading, ref_pos, ref_heading, ref_valid))
    )
    flat = (cand_pos.reshape(R, M * Tn, 2), cand_heading.reshape(R, M * Tn))
    dd_pl, da_pl = refline_matrices_pallas(
        *map(jnp.asarray, flat + (ref_pos, ref_heading, ref_valid)), interpret=True
    )
    got_d, got_a, idx = refline_matrices_ref(
        *map(T, flat + (ref_pos, ref_heading, ref_valid)), return_index=True
    )
    for ref_d, ref_a in ((dd, da), (dd_pl, da_pl)):
        np.testing.assert_allclose(got_d.numpy().reshape(R, M, Tn), np.asarray(ref_d).reshape(R, M, Tn), atol=1e-4)
        np.testing.assert_allclose(got_a.numpy().reshape(R, M, Tn), np.asarray(ref_a).reshape(R, M, Tn), atol=1e-4)
    d2 = ((cand_pos.reshape(R, -1, 1, 2) - ref_pos[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), np.where(ref_valid[:, None], d2, np.inf).argmin(-1))


def _retrack_case():
    """test_evaluator.py:152's case."""
    rng = np.random.default_rng(3)
    G, Tn = 7, jev.NUM_FRAMES
    t = np.arange(Tn, dtype=np.float32)
    paths = []
    for _ in range(G):
        v = rng.uniform(0.3, 1.5)
        curve = rng.uniform(-0.02, 0.02)
        x = t * v
        paths.append(np.stack([x, curve * x**2 / 10.0], axis=-1))
    ref_pos = np.stack(paths).astype(np.float32)
    ref_heading = np.arctan2(
        np.gradient(ref_pos[..., 1], axis=1), np.gradient(ref_pos[..., 0], axis=1) + 1e-9
    ).astype(np.float32)
    v0 = rng.uniform(0.0, 12.0, G).astype(np.float32)
    return ref_pos, ref_heading, v0


def test_rollout_candidates_matches_jax():
    ref_pos, ref_heading, v0 = _retrack_case()
    got = tev.rollout_candidates(T(ref_pos), T(ref_heading), T(v0))
    ref = retrack_rollout_pallas(*map(jnp.asarray, (ref_pos, ref_heading, v0)), jev.NUM_FRAMES,
                                 interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3)
    n = 12
    short = (ref_pos[:, :n], ref_heading[:, :n])
    got = tev.rollout_candidates(*map(T, short), T(v0), num_frames=n)
    ref = jev.rollout_candidates(*map(jnp.asarray, short), jnp.asarray(v0), num_frames=n)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3)


def _retrack_tie_case(Tn):
    """Candidates whose closest-point search meets exact ties, the cases
    the kernel's split search must resolve as the serial one does: paths
    that stand still (every point the same, so every distance is equal and
    the first index wins), from rest and from a start speed, and paths
    that double back on themselves (out and back over the same points, so
    each outbound point ties with its return twin)."""
    rng = np.random.default_rng(8)
    G = 8
    t = np.arange(Tn, dtype=np.float32)
    ref_pos = np.zeros((G, Tn, 2), np.float32)
    ref_pos[:4] = rng.uniform(-50, 50, (4, 1, 2))
    s = np.minimum(t, Tn - 1 - t)  # 0, 1, ..., 1, 0: the same floats out and back
    for g in range(4, G):
        yaw = rng.uniform(-np.pi, np.pi)
        step = rng.uniform(0.3, 1.5) * np.array([np.cos(yaw), np.sin(yaw)], np.float32)
        ref_pos[g] = rng.uniform(-50, 50, 2) + s[:, None] * step
    ref_heading = np.repeat(rng.uniform(-np.pi, np.pi, (G, 1)), Tn, 1).astype(np.float32)
    v0 = np.array([0.0, 0.5, 3.0, 8.0, 0.0, 2.0, 5.0, 10.0], np.float32)
    return ref_pos, ref_heading, v0


@pytest.mark.parametrize("Tn", [12, jev.NUM_FRAMES])
def test_retrack_ties_match_jax(Tn):
    """The plain re-tracking on standing-still and doubled-back candidates
    against the Pallas kernel in interpret mode and, over the 12-frame
    horizon, the lax.scan, at test_evaluator.py's 2e-3."""
    ref_pos, ref_heading, v0 = _retrack_tie_case(Tn)
    got = retrack_rollout_ref(T(ref_pos), T(ref_heading[:, 0]), T(v0))
    refs = [retrack_rollout_pallas(*map(jnp.asarray, (ref_pos, ref_heading, v0)), Tn,
                                   interpret=True)]
    if Tn == 12:
        refs.append(jev.rollout_candidates(*map(jnp.asarray, (ref_pos, ref_heading, v0)),
                                           num_frames=Tn))
    for ref in refs:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3)
    # the standing-still candidate from rest never moves
    np.testing.assert_array_equal(got[0][0].numpy(), np.broadcast_to(ref_pos[0, :1], (Tn, 2)))
    assert (got[2][0] == 0).all()


def test_refline_ties_match_jax():
    """The plain reference-line matrices on exact ties and on lines whose
    valid points are scattered, not a prefix, against the XLA path and the
    Pallas kernel in interpret mode (1e-4), nearest indices equal to the
    first argmin. Line points sit at the integers of the x axis with
    headings of their own, candidates at x = k + 0.5 and y a multiple of
    0.5: every distance is exact, so a candidate halfway between two valid
    points ties, and the lower index must win."""
    rng = np.random.default_rng(12)
    R, M, Tn, Nr = 4, 3, 16, 40
    cand_pos = np.stack([rng.integers(0, Nr - 1, (R, M, Tn)) + 0.5,
                         0.5 * rng.integers(-6, 7, (R, M, Tn))], -1).astype(np.float32)
    cand_heading = rng.uniform(-np.pi, np.pi, (R, M, Tn)).astype(np.float32)
    ref_pos = np.stack(np.broadcast_arrays(np.arange(Nr, dtype=np.float32),
                                           np.zeros((R, 1), np.float32)), -1).copy()
    ref_heading = rng.uniform(-0.5, 0.5, (R, Nr)).astype(np.float32)
    ref_valid = np.ones((R, Nr), bool)  # line 0: every point, so every candidate between two ties
    ref_valid[1] = rng.random(Nr) < 0.3  # scattered
    ref_valid[2, ::3] = False
    ref_valid[3] = False
    ref_valid[3, [2, 9, 10, 31]] = True
    args = (cand_pos, cand_heading, ref_pos, ref_heading, ref_valid)
    dd, da = jev.ref_line_matrices(*map(jnp.asarray, args))
    flat = (cand_pos.reshape(R, M * Tn, 2), cand_heading.reshape(R, M * Tn))
    dd_pl, da_pl = refline_matrices_pallas(
        *map(jnp.asarray, flat + (ref_pos, ref_heading, ref_valid)), interpret=True
    )
    got_d, got_a, idx = refline_matrices_ref(
        *map(T, flat + (ref_pos, ref_heading, ref_valid)), return_index=True
    )
    for ref_d, ref_a in ((dd, da), (dd_pl, da_pl)):
        np.testing.assert_allclose(got_d.numpy().reshape(R, M, Tn), np.asarray(ref_d).reshape(R, M, Tn), atol=1e-4)
        np.testing.assert_allclose(got_a.numpy().reshape(R, M, Tn), np.asarray(ref_a).reshape(R, M, Tn), atol=1e-4)
    d2 = ((flat[0][:, :, None] - ref_pos[:, None]) ** 2).sum(-1)
    d2 = np.where(ref_valid[:, None], d2, np.inf)
    want = d2.argmin(-1)
    np.testing.assert_array_equal(idx.numpy(), want)
    ties = (d2 == d2.min(-1, keepdims=True)).sum(-1) > 1
    assert ties[0].all() and ties[1:].any()  # the ties are there, and the lower index won
    assert (ref_pos[np.arange(R)[:, None], want][..., 0] < flat[0][..., 0])[ties].all()


def test_forecast_kinematics_reward_match_jax():
    r = np.random.default_rng(9)
    B, N = 3, 4
    pos = r.uniform(-50, 50, (B, N, 2)).astype(np.float32)
    heading = r.uniform(-np.pi, np.pi, (B, N)).astype(np.float32)
    speed = r.uniform(0, 12, (B, N)).astype(np.float32)
    control = np.stack([r.uniform(0, 1, (B, N)), r.uniform(-1, 1, (B, N)),
                        (r.random((B, N)) < 0.3)], -1).astype(np.float32)
    shape = r.uniform(1, 5, (B, N, 2)).astype(np.float32)
    valid = r.random((B, N)) < 0.7
    args = (pos, heading, speed, control, shape, valid)
    ref = jax.vmap(jev.forecast_neighbors)(*map(jnp.asarray, args))
    got = tev.forecast_neighbors(*map(T, args))
    for g, x in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5)

    hd = np.cumsum(r.normal(0, 0.3, (6, 40)), -1).astype(np.float32)
    sp = r.uniform(0, 15, (6, 40)).astype(np.float32)
    sp[0, 20:] = 1e-41  # a halted rollout: subnormal speeds are zero in XLA
    ref = jev.derive_kinematics(jnp.asarray(hd), jnp.asarray(sp))
    got = tev.derive_kinematics(T(hd), T(sp))
    for g, x, tol in zip(got, ref, (1e-5, 1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=tol, rtol=1e-6)
    assert (got[0][0, 25:] == 0).all() and (got[1][0, 25:] == 0).all()

    n = 500
    reward_in = [
        r.uniform(0, 3, n), r.uniform(-np.pi, np.pi, n), r.uniform(-1, 25, n),
        r.uniform(-8, 8, n), r.uniform(-1, 1, n), r.uniform(-8, 8, n),
        r.random(n) < 0.2, r.random(n) < 0.2,
    ]
    reward_in = [np.abs(x).astype(np.float32) if i < 2 else np.asarray(x, np.float32)
                 for i, x in enumerate(reward_in)]
    reward_in[2][:20] = 0.0
    reward_in[3][:10] = 0.0  # standing still: no time penalty
    np.testing.assert_allclose(
        tev.dense_reward(*map(T, reward_in)).numpy(),
        np.asarray(jev.dense_reward(*map(jnp.asarray, reward_in))), atol=1e-5,
    )


def _advantage_inputs(num_frames):
    """Two CBVs on a straight two-lane road, 2 reference lines x 3 modes:
    one with a parked car 8 m ahead, one with a slow leader; one reference
    line of the second CBV is invalid."""
    B, R, M, Tn, Nr = 2, 2, 3, 80, 120
    t = np.arange(Tn, dtype=np.float32)
    traj = np.zeros((B, R, M, Tn, 6), np.float32)
    for b in range(B):
        for ri in range(R):
            for m in range(M):
                x = t * 0.35 * (m + 1) * (b + 1) * 0.8
                y = np.zeros(Tn) if ri == 0 else 0.3 * t
                traj[b, ri, m, :, 0], traj[b, ri, m, :, 1] = x, y
                traj[b, ri, m, :, 2] = 1.0
                traj[b, ri, m, :, 3] = 0.0 if ri == 0 else 0.28
    rx = np.linspace(0, 119, Nr, dtype=np.float32)
    line = lambda slope: np.stack([rx, slope * rx], -1)
    ref_pos = np.broadcast_to(np.stack([line(0.0), line(0.3)]), (B, R, Nr, 2)).copy()
    ref_heading = np.zeros((B, R, Nr), np.float32)
    ref_heading[:, 1] = 0.29
    ref_point_valid = np.ones((B, R, Nr), bool)
    ref_point_valid[1, 0, 90:] = False
    r_valid = np.array([[True, True], [True, False]])
    f = lambda *a: np.asarray(a, np.float32)
    return (
        traj, r_valid, ref_pos, ref_heading, ref_point_valid,
        f([50.0, 0.0], [120.0, 0.0]), f(0.0, 0.0), f(5.0, 9.0),
        f([2.0, 4.5], [2.0, 4.5]),
        f([[58.0, 0.0], [0.0, 50.0]], [[135.0, 0.0], [121.0, -3.5]]),
        f([0.0, 0.0], [0.0, 3.1]), f([0.0, 0.0], [4.0, 6.0]),
        np.zeros((B, 2, 3), np.float32) + f([0.4, 0.0, 0.0]),
        np.tile(f([2.0, 4.5]), (B, 2, 1)),
        np.array([[True, False], [True, True]]),
    ), num_frames


def test_grpo_advantage_batched_matches_jax():
    args, n = _advantage_inputs(20)
    jmap = jax_straight_town(length=400.0, num_lanes=2, pad_lanes_to=16)
    tmap = make_straight_town(length=400.0, num_lanes=2, pad_lanes_to=16, device="cpu")
    ref = jev.grpo_advantage_batched(jmap, *map(jnp.asarray, args), num_frames=n)
    got = tev.grpo_advantage_batched(tmap, *map(T, args), num_frames=n)
    np.testing.assert_array_equal(got["valid_mask"].numpy(), np.asarray(ref["valid_mask"]))
    for k in ("rollout_return", "advantage"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-3, err_msg=k)
    ret = got["rollout_return"].numpy()
    assert np.ptp(ret[0, 0]) > 0.1  # the modes' speeds tell their returns apart
