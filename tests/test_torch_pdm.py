"""The port's PDM-Lite ego (ego/pdm_ego.py) and the closed loop with the
JAX CLI's eval defaults against the JAX package's, on the CPU.

`pdm_ego_waypoints` with and without `lane_change` on three scene sets:
tests/test_pdm_ego.py's hand-made scenes without a map (a free road, a
parked blocker, a stuck ego, crossing traffic); the straight town with a
parked blocker on one ego's route, where the expert overtakes; and the
grid town's lights, stop signs and junctions. Then one `rollout_chunk` of
three ticks with the PDM ego, 2 walkers and 2 static obstacles per
scenario and the Pluto CBVs on legacy tokens (the seeded depth-1 model of
test_torch_legacy.py), against JAX `rollout_chunk(ego="pdm",
canonical=False)`.

Tolerances: waypoints 1e-4 (observed 7.6e-6: f32 route points ~100 m
out, where an ulp is 7.6e-6); the chunk's states and criteria as
test_torch_rollout.py's, integers and bools exactly and floats 1e-3
(atol and rtol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ego.pdm_ego import pdm_ego_waypoints as jax_pdm
from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.map import make_straight_town as jax_straight_town
from rift_tpu.models.pluto import PlutoModel as JaxPluto
from rift_tpu.models.pluto import build_cbv_features as jax_build_features
from rift_tpu.rollout import rollout_chunk as jax_rollout_chunk
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import cbv_slot_assignment as jax_slots
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.sim import ScenarioSpec, init_sim_state
from rift_tpu.utils.params_io import save_params_npz
from rift_tpu_torch.ego.pdm_ego import pdm_ego_waypoints
from rift_tpu_torch.models.pluto import PlutoModel
from rift_tpu_torch.rollout import rollout_chunk
from rift_tpu_torch.sim.state import CLASS_STATIC, CLASS_WALKER
from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params, load_params_npz
from test_torch_pluto import _seeded_params
from test_torch_train import _flat
from torch_parity import (
    assert_fields_match,
    crit_from_jax,
    map_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
    stepped_scene,
)


def _hand_scenes():
    """test_pdm_ego.py's four scenes as four scenarios of one batch: a
    route along +x, the ego at x=10, and a free road, a parked car 15 m
    ahead, a stuck ego (still for the whole history) with a car 12 m
    ahead, and a car crossing the route."""
    S, rw = 4, 400
    route = np.zeros((S, rw, 3), np.float32)
    route[:, :, 0] = np.arange(rw)
    spec = ScenarioSpec(
        ego_route=jnp.asarray(route), ego_route_len=jnp.full((S,), rw, jnp.int32),
        route_road_ids=jnp.full((S, 16), -1, jnp.int32),
        route_lane_ids=jnp.zeros((S, 16), jnp.int32),
        ego_target_speed=jnp.full((S,), 8.0), timeout_ticks=jnp.full((S,), 4000, jnp.int32),
    )
    st = init_sim_state(S, 2)
    pos = np.array([[[10, 0], [10, 60]], [[10, 0], [25, 0]], [[10, 0], [22, 0]],
                    [[10, 0], [26, -8]]], np.float32)
    heading = np.array([[0, 0], [0, 0], [0, 0], [0, np.pi / 2]], np.float32)
    speed = np.array([[5, 0], [8, 0], [0, 0], [8, 4]], np.float32)
    hist_pos, hist_valid = np.array(st.hist_pos), np.array(st.hist_valid)
    hist_pos[2, 0], hist_valid[2, 0] = (10.0, 0.0), True
    st = st.replace(pos=jnp.asarray(pos), heading=jnp.asarray(heading),
                    speed=jnp.asarray(speed), alive=jnp.ones((S, 2), bool),
                    hist_pos=jnp.asarray(hist_pos), hist_valid=jnp.asarray(hist_valid))
    return None, spec, st


def _town_scene(jmap):
    """Four scenarios with 2 walkers and 2 statics each, every BV awake,
    six ticks on the PDM ego (the port's env and ego), then a car parked
    15 m ahead on scenario 0's route."""
    env = JaxTrafficEnv(jmap, num_scenarios=4, num_agents=8, seed=21, num_walkers=2,
                        num_statics=2)
    jstate, crit, jspec = env.reset()
    jstate = jax_wake(jstate)
    jstate, _ = stepped_scene(jmap, jstate, crit, jspec, 6, ego=pdm_ego_waypoints)
    route = np.asarray(jspec.ego_route[0])
    i = int(np.argmin(((route[:, :2] - np.asarray(jstate.pos[0, 0])) ** 2).sum(-1))) + 15
    jstate = jstate.replace(
        pos=jstate.pos.at[0, 1].set(route[i, :2]), heading=jstate.heading.at[0, 1].set(route[i, 2]),
        speed=jstate.speed.at[0, 1].set(0.0), alive=jstate.alive.at[0, 1].set(True),
    )
    return jmap, jspec, jstate


@pytest.fixture(scope="module")
def scenes():
    return {
        "hand": _hand_scenes(),
        "straight": _town_scene(jax_straight_town(length=400.0, num_lanes=2)),
        "grid": _town_scene(jax_grid_town(blocks=1, num_lanes=2)),
    }


@pytest.mark.parametrize("lane_change", [False, True])
def test_pdm_ego_waypoints_match(scenes, lane_change):
    """Both modes on every scene set; the expert's overtake is exercised
    (the straight town's blocked scenario shifts by a lane width)."""
    got = {}
    for name, (jmap, jspec, jstate) in scenes.items():
        ref = np.asarray(jax_pdm(jspec, jstate, jmap, lane_change=lane_change))
        tmap = None if jmap is None else map_from_jax(jmap)
        got[name] = pdm_ego_waypoints(spec_from_jax(jspec), state_from_jax(jstate), tmap,
                                      lane_change=lane_change).numpy()
        np.testing.assert_allclose(got[name], ref, atol=1e-4, err_msg=name)
    spacing = np.linalg.norm(np.diff(got["hand"], axis=1), axis=-1).mean(1)
    assert spacing[1] < 0.8 * spacing[0] and spacing[3] < spacing[0]  # brakes for hazards
    if lane_change:
        jmap, jspec, jstate = scenes["straight"]
        stay = pdm_ego_waypoints(spec_from_jax(jspec), state_from_jax(jstate),
                                 map_from_jax(jmap)).numpy()
        assert np.abs(got["straight"][0] - stay[0]).max() > 3.0  # one lane over
        np.testing.assert_array_equal(got["straight"][1:], stay[1:])


def test_pdm_rollout_chunk_matches(tmp_path):
    """Three ticks of the JAX CLI's default eval loop: the PDM ego computed
    in the tick loop, 2 walkers and 2 statics, the Pluto CBVs on legacy
    tokens planning every tick, then the env step."""
    S, A, C = 2, 10, 2
    jmap = jax_grid_town(blocks=1, num_lanes=2)
    env = JaxTrafficEnv(jmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=5,
                        num_walkers=2, num_statics=2)
    jstate, jcrit, jspec = env.reset()
    jstate = jax_wake(jstate)
    cbv = jnp.zeros((S, A), bool).at[:, 1:C + 1].set(jstate.alive[:, 1:C + 1])
    jstate = jstate.replace(
        is_cbv=cbv, goal_valid=cbv,
        goal=jstate.goal.at[:, 1:C + 1].set(jstate.pos[:, 1:C + 1] + jnp.array([60.0, 0.0])),
    )
    jmodel = JaxPluto(encoder_depth=1, decoder_depth=1, dtype=jnp.float32)
    batch = jax.eval_shape(lambda *a: _flat(jax_build_features(*a)[0]), jmap, jstate,
                           jax_slots(jstate.is_cbv, C), jspec)
    params = _seeded_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch))
    path = str(tmp_path / "pluto.npz")
    save_params_npz(params, path)
    model = PlutoModel(encoder_depth=1, decoder_depth=1, dtype=torch.float32, device="cpu")
    load_jax_params(model, flatten_params(load_params_npz(path)))

    ref = jax_rollout_chunk(jmodel, params, jmap, jspec, jstate, jcrit, max_cbvs=C,
                            num_steps=3, ego="pdm", canonical=False)
    got = rollout_chunk(model, map_from_jax(jmap), spec_from_jax(jspec),
                        state_from_jax(jstate), crit_from_jax(jcrit), max_cbvs=C,
                        num_steps=3, ego="pdm", canonical=False, tick=0)
    cls = got[0].agent_class.numpy()
    assert ((cls == CLASS_WALKER).sum(1) == 2).all() and ((cls == CLASS_STATIC).sum(1) == 2).all()
    assert int(got[0].is_cbv.sum()) > 0 and int(got[1].cbv_count.sum()) > 0
    assert_fields_match(ref[0], got[0], atol=1e-3, rtol=1e-3)
    assert_fields_match(ref[1], got[1], atol=1e-3, rtol=1e-3)
