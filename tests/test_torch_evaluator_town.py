"""The port's autopilot teacher and the evaluator's reference-line matrices
against the JAX package, on the same numpy-seeded inputs, in f32 on the
CPU (where the refline wrapper runs its plain version).

Tolerances:
- lane_follow_waypoints 1e-4 m and autopilot_steady_speed 1e-5 m/s (f32
  projections over a 100 m town);
- ref_line_matrices 1e-4 against both the XLA path and the Pallas kernel
  in interpret mode (test_evaluator.py's bound), nearest indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.ops.refline import refline_matrices_pallas
from rift_tpu.rl import evaluator as jev
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.sim.autopilot import lane_follow_waypoints as jax_lane_follow
from rift_tpu.sim.world import autopilot_steady_speed as jax_steady_speed
from rift_tpu_torch.ops.refline import refline_matrices_ref
from rift_tpu_torch.sim.autopilot import lane_follow_waypoints
from rift_tpu_torch.sim.world import autopilot_steady_speed
from torch_parity import map_from_jax, one_torch_thread, state_from_jax

T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


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
