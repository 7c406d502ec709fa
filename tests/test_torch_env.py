"""The port's environment step against the JAX package's, on the CPU, on
`test_torch_world.py`'s scene (S=2, A=10, C=2, two CBVs per scenario on
given trajectories): `scenario.env_step` (rule ego, IDM autopilot, world
tick, criteria, churn) for five ticks; rule recognition across its warm-up
boundary (tick 25, then every 2 ticks), and `recognize_cbvs` alone; a
reset with walkers and static obstacles and five ticks of them; and, as
the world part of the slice as a whole, the world-only `rollout_chunk`
(K=5) against five JAX `env_step`s, its scan's body.

Every JAX env step here gets [S, A, 80, 2] trajectories (all-False masks
where no agent follows one), so that it compiles once.

Tolerances: every integer and bool field exactly (lanes, branch bits,
collisions, off-road and stop-sign flags, is_cbv, goal validity, the
criteria's counts, histograms and criticality distributions); float
fields within 1e-4 (atol and rtol: the same f32 arithmetic, rounded by
another library over a few chained ticks); the promoted goals 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.scenario.env import env_step as jax_env_step
from rift_tpu.scenario.recognition import RECOG_WARMUP_TICKS
from rift_tpu.scenario.recognition import recognize_cbvs as jax_recognize
from rift_tpu_torch.rollout import rollout_chunk
from rift_tpu_torch.scenario import TrafficEnv, env_step, recognize_cbvs
from rift_tpu_torch.sim.state import CLASS_STATIC, CLASS_WALKER
from test_torch_world import A, C, S, TOL, jax_scene
from torch_parity import (
    assert_fields_match,
    crit_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
)


@pytest.fixture(scope="module")
def scene():
    return jax_scene()


def test_env_step_matches(scene):
    """Five env ticks with the CBVs on their trajectories, checked after the
    first and the last: state and criteria (the five histograms, the ego
    criticality distributions and every event count exactly)."""
    jtraj, jmask = jnp.asarray(scene["traj"]), jnp.asarray(scene["mask"])
    ttraj, tmask = torch.from_numpy(scene["traj"]), torch.from_numpy(scene["mask"])
    jstate, jcrit = scene["jstate"], scene["jcrit"]
    spec = spec_from_jax(scene["jspec"])
    state, crit = state_from_jax(jstate), crit_from_jax(jcrit)
    for k in range(5):
        jstate, jcrit = jax_env_step(
            scene["jmap"], scene["jspec"], jstate, jcrit, cbv_traj=jtraj, cbv_traj_mask=jmask,
            max_cbvs=C,
        )
        state, crit = env_step(
            scene["tmap"], spec, state, crit, cbv_traj=ttraj, cbv_traj_mask=tmask,
            max_cbvs=C, tick=k,
        )
        if k in (0, 4):
            assert_fields_match(jstate, state, **TOL)
            assert_fields_match(jcrit, crit, **TOL)
    assert int(crit.cbv_count.sum()) > 0 and int(crit.cbv_speed_hist.sum()) > 0


def test_recognition_across_warmup(scene):
    """A fresh reset (BVs pooled, no CBV) stepped from tick 23 to 29: no
    promotion before the warm-up ends, promotions on its cadence after;
    recognize_cbvs itself matched on the state of the first promotion. No
    agent follows a trajectory (an all-False mask, as test_env_step's)."""
    env = JaxTrafficEnv(scene["jmap"], num_scenarios=S, num_agents=A, max_cbvs=C, seed=5)
    jstate, jcrit, jspec = env.reset()
    jstate = jstate.replace(tick=jstate.tick + RECOG_WARMUP_TICKS - 2)
    spec = spec_from_jax(jspec)
    state, crit = state_from_jax(jstate), crit_from_jax(jcrit)
    traj = np.zeros_like(scene["traj"])
    jtraj, jmask = jnp.asarray(traj), jnp.zeros((S, A), bool)
    ttraj, tmask = torch.from_numpy(traj), torch.zeros((S, A), dtype=torch.bool)
    promoted_at = []
    for tick in range(RECOG_WARMUP_TICKS - 2, RECOG_WARMUP_TICKS + 4):
        before = jstate
        jstate, jcrit = jax_env_step(
            scene["jmap"], jspec, jstate, jcrit, cbv_traj=jtraj, cbv_traj_mask=jmask, max_cbvs=C
        )
        state, crit = env_step(
            scene["tmap"], spec, state, crit, cbv_traj=ttraj, cbv_traj_mask=tmask,
            max_cbvs=C, tick=tick,
        )
        assert_fields_match(jstate, state, atol=1e-4, rtol=1e-4)
        if (np.asarray(jstate.is_cbv) & ~np.asarray(before.is_cbv)).any():
            promoted_at.append(tick + 1)
    assert promoted_at and min(promoted_at) > RECOG_WARMUP_TICKS
    assert all(t % 2 == 0 for t in promoted_at)

    # the recognizer alone, on a state where it promotes
    jstate = jstate.replace(is_cbv=jnp.zeros_like(jstate.is_cbv))
    ref = jax_recognize(scene["jmap"], jspec, jstate, C)
    got = recognize_cbvs(scene["tmap"], spec, state_from_jax(jstate), C)
    assert np.asarray(ref[4]).any()
    for name, r, g in zip(("is_cbv", "goal", "goal_valid", "interaction", "promote"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4, err_msg=name)


def test_walkers_and_statics_match(scene):
    """A reset with 2 walkers and 2 static obstacles per scenario (the JAX
    CLI's eval defaults, rift_tpu/run.py:402-409) from one seed in both
    packages, then five env ticks with every pooled BV awake and no
    trajectory: the spawn of the last slots, the walkers' patrol, the
    autopilot's yield to walkers, and the pedestrian and static collision
    counts of the criteria. Ints and bools exactly, floats 1e-4."""
    kw = dict(num_scenarios=S, num_agents=A, max_cbvs=C, seed=5, num_walkers=2, num_statics=2)
    jstate, jcrit, jspec = JaxTrafficEnv(scene["jmap"], **kw).reset()
    state, crit, spec = TrafficEnv(scene["tmap"], device="cpu", **kw).reset()
    assert_fields_match(jstate, state, atol=0.0, rtol=0.0)
    assert_fields_match(jcrit, crit, atol=0.0, rtol=0.0)
    cls = state.agent_class.numpy()
    assert ((cls == CLASS_WALKER).sum(1) == 2).all() and ((cls == CLASS_STATIC).sum(1) == 2).all()

    jstate = jax_wake(jstate)
    state = state_from_jax(jstate)
    spec = spec_from_jax(jspec)
    start = state.pos.clone()
    traj = np.zeros_like(scene["traj"])
    jtraj, jmask = jnp.asarray(traj), jnp.zeros((S, A), bool)
    ttraj, tmask = torch.from_numpy(traj), torch.zeros((S, A), dtype=torch.bool)
    for k in range(5):
        jstate, jcrit = jax_env_step(
            scene["jmap"], jspec, jstate, jcrit, cbv_traj=jtraj, cbv_traj_mask=jmask, max_cbvs=C
        )
        state, crit = env_step(
            scene["tmap"], spec, state, crit, cbv_traj=ttraj, cbv_traj_mask=tmask,
            max_cbvs=C, tick=k,
        )
    assert_fields_match(jstate, state, atol=1e-4, rtol=1e-4)
    assert_fields_match(jcrit, crit, atol=1e-4, rtol=1e-4)
    moved = (state.pos - start).norm(dim=-1)
    assert (moved[torch.from_numpy(cls == CLASS_WALKER)] > 0.0).all()  # the patrol walks
    assert (moved[torch.from_numpy(cls == CLASS_STATIC)] == 0.0).all()


def test_world_only_rollout_matches(scene):
    """The port's world-only rollout_chunk (K=5) against its JAX body,
    env_step with no policy, called five times (compiled once for the
    module: all-False trajectory masks leave every agent to the rule ego
    and the autopilot, as the JAX chunk's cbv_traj=None does)."""
    jstate, jcrit = scene["jstate"], scene["jcrit"]
    jtraj, jmask = jnp.zeros_like(scene["traj"]), jnp.zeros((S, A), bool)
    for _ in range(5):
        jstate, jcrit = jax_env_step(
            scene["jmap"], scene["jspec"], jstate, jcrit, cbv_traj=jtraj, cbv_traj_mask=jmask,
            max_cbvs=C,
        )
    state, crit, extras = rollout_chunk(
        None, scene["tmap"], spec_from_jax(scene["jspec"]), state_from_jax(scene["jstate"]),
        crit_from_jax(scene["jcrit"]), max_cbvs=C, num_steps=5, with_policy=False, tick=0,
    )
    assert extras is None and int(state.tick[0]) == 5
    assert_fields_match(jstate, state, atol=1e-4, rtol=1e-4)
    assert_fields_match(jcrit, crit, atol=1e-4, rtol=1e-4)
