"""The GRPO evaluator's reference-line ties, neighbour forecast,
kinematics, reward and batched advantage against the JAX package, on the
same numpy-seeded inputs, in f32 on the CPU (where the retrack and
refline wrappers run their plain versions).

Tolerances:
- the reference-line ties 1e-4 against both the XLA path and the Pallas
  kernel in interpret mode, nearest indices exactly;
- forecast_neighbors, derive_kinematics and dense_reward 1e-5 (1e-4 for
  the yaw acceleration, three chained differences at dt = 0.1);
- grpo_advantage_batched at B=2 over a 20-frame horizon: returns 1e-3,
  advantages 1e-3, the valid mask exactly. The 40-frame evaluator is held
  against the JAX package through the train act step in
  test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rift_tpu.map import make_straight_town as jax_straight_town
from rift_tpu.ops.refline import refline_matrices_pallas
from rift_tpu.rl import evaluator as jev
from rift_tpu_torch.map import make_straight_town
from rift_tpu_torch.ops.refline import refline_matrices_ref
from rift_tpu_torch.rl import evaluator as tev
from torch_parity import one_torch_thread

T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


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
