"""The port's world tick against the JAX package's, on the CPU: from one
seeded reset of the small grid town (S=2, A=10, C=2) in which two
background vehicles per scenario are CBVs on given local trajectories
(numpy-seeded speeds and curvatures), `sim.world.step` for one and five
ticks; and the tracker's waypoint resampling (`densify_local_waypoints`,
`extend_path`). `jax_scene` builds that scene once per process for the
closed-loop tests of `test_torch_env.py` and `test_torch_rollout.py` too.

Tolerances: every integer and bool field exactly (lanes, branch bits,
collisions and their partner slots, off-road and stop-sign flags, is_cbv,
goal validity); float fields within 1e-4 (atol and rtol: the same f32
arithmetic, with transcendental functions and reductions rounded by
another library over a few chained ticks); the resampling 1e-6. The loop
is chaotic over many ticks (nearest-lane argmins, thresholds), so the
closed-loop tests hold only a few.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.sim.pid import densify_local_waypoints as jax_densify
from rift_tpu.sim.pid import extend_path as jax_extend_path
from rift_tpu.sim.world import step as jax_world_step
from rift_tpu_torch.sim import densify_local_waypoints, extend_path
from rift_tpu_torch.sim import step as world_step
from torch_parity import (
    assert_fields_match,
    map_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
)

S, A, C = 2, 10, 2
TOL = dict(atol=1e-4, rtol=1e-4)


def _cbv_traj(seed=0, T=80):
    """[S, A, T, 2] local waypoints: 5-10 m/s ahead on a gentle arc. T=80,
    as the planner's, so that every JAX env step of the closed-loop tests
    compiles once."""
    r = np.random.default_rng(seed)
    v = r.uniform(5.0, 10.0, (S, A, 1))
    kappa = r.uniform(-0.01, 0.01, (S, A, 1))
    x = v * 0.1 * np.arange(1, T + 1)
    return np.stack([x, kappa * x * x], -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_scene():
    """A seeded JAX reset of the small grid town with every pooled BV awake
    and CBVs forced on slots 1..C, the port's map, and the CBVs' given
    trajectories and mask (numpy). Made once per process; read-only."""
    jmap = jax_grid_town(blocks=1, num_lanes=2)
    env = JaxTrafficEnv(jmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=5)
    jstate, jcrit, jspec = env.reset()
    jstate = jax_wake(jstate)
    mask = np.zeros((S, A), bool)
    mask[:, 1:C + 1] = np.asarray(jstate.alive[:, 1:C + 1])
    jstate = jstate.replace(
        is_cbv=jnp.asarray(mask),
        goal=jstate.goal.at[:, 1:C + 1].set(jstate.pos[:, 1:C + 1] + jnp.array([60.0, 0.0])),
        goal_valid=jnp.asarray(mask),
    )
    assert mask.any()
    return {
        "jmap": jmap, "jspec": jspec, "jstate": jstate, "jcrit": jcrit,
        "tmap": map_from_jax(jmap),
        "traj": _cbv_traj(), "mask": mask,
    }


@pytest.fixture(scope="module")
def scene():
    return jax_scene()


def test_waypoint_resampling_matches():
    """densify_local_waypoints (sparse 0.5 s knots to the tracker's 0.1 s
    grid, extrapolating past the last knot) and extend_path (one point,
    and a 4-point path to 30), 1e-6."""
    r = np.random.default_rng(2)
    sparse = np.cumsum(r.uniform(0, 5, (S, 4, 2)), axis=1).astype(np.float32)
    np.testing.assert_allclose(
        densify_local_waypoints(torch.from_numpy(sparse)).numpy(),
        np.asarray(jax_densify(jnp.asarray(sparse))), atol=1e-6,
    )
    for path in (sparse, sparse[:, :1]):
        np.testing.assert_allclose(
            extend_path(torch.from_numpy(path), 30).numpy(),
            np.asarray(jax_extend_path(jnp.asarray(path), 30)), atol=1e-6,
        )


@pytest.mark.parametrize("ticks", [1, 5])
def test_world_step_matches(scene, ticks):
    jtraj, jmask = jnp.asarray(scene["traj"]), jnp.asarray(scene["mask"])
    ttraj, tmask = torch.from_numpy(scene["traj"]), torch.from_numpy(scene["mask"])
    jstate, spec = scene["jstate"], spec_from_jax(scene["jspec"])
    state = state_from_jax(jstate)
    for _ in range(ticks):
        jstate = jax_world_step(scene["jmap"], scene["jspec"], jstate, traj=jtraj, traj_mask=jmask)
        state = world_step(scene["tmap"], spec, state, traj=ttraj, traj_mask=tmask)
    assert int(state.tick[0]) == ticks
    assert float(state.speed.max()) > 0.3  # the scene moves
    assert_fields_match(jstate, state, **TOL)
