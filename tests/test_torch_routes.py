"""Route towns and a closed loop on one, against the JAX package, on the
CPU.

A small Bench2Drive-schema route file (torch_parity.write_route_file: a
straight route, an L with a corner and a crossing pair, each with weather
keyframes). The route towns: every TensorMap field of `map_from_routes`
on the four routes (stop_ratio 0.5, a pad of 128 lanes that grows to 256)
and of `shared_map_from_routes`, with the lane paths equal. Then the slice
as a whole: a reset on the route town with each scenario on its route,
and five ticks of the world with a small PlanT ego (`rollout_chunk`, ego
"plant") and attention recognition from tick 26 on (recognition at ticks
28 and 30), against the JAX env_step fed the JAX PlanT's waypoints, with
the same weights (the JAX npz loaded strictly). The file's parsing, the
data loaders and compiled npz towns are test_torch_routes_files.py.

Tolerances: integer and bool fields exactly; the maps' float fields 1e-5
(the same numpy builders; the port's copy is bit-identical in practice);
the reset exactly; after five ticks floats 1e-4 (test_torch_env's bound:
the same f32 arithmetic by another library over a few ticks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map import route_waypoints as jax_route_waypoints
from rift_tpu.map.from_route import map_from_routes as jax_map_from_routes
from rift_tpu.map.from_route import shared_map_from_routes as jax_shared_map
from rift_tpu.models.plant import PlanTModel as JaxPlanT
from rift_tpu.models.plant import plant_ego_waypoints as jax_plant_waypoints
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.scenario.env import env_step as jax_env_step
from rift_tpu.utils.params_io import save_params_npz as jax_save_params
from rift_tpu_torch.map import route_waypoints
from rift_tpu_torch.map.from_route import map_from_routes, shared_map_from_routes
from rift_tpu_torch.models.plant import PlanTModel
from rift_tpu_torch.models.plant.train import load_plant_weights
from rift_tpu_torch.rollout import rollout_chunk
from rift_tpu_torch.scenario import TrafficEnv, routes, wake_all_bvs
from torch_parity import assert_fields_match, one_torch_thread, write_route_file

MAP_TOL = dict(atol=1e-5, rtol=1e-5)
S, A, C = 4, 24, 1


@pytest.fixture(scope="module")
def route_file(tmp_path_factory):
    return write_route_file(tmp_path_factory.mktemp("routes") / "routes.xml")


@pytest.fixture(scope="module")
def towns(route_file):
    """Both packages' route towns of the four routes and their shared towns."""
    kps = [c.keypoints for c in routes.parse_routes_file(route_file)]
    kw = dict(num_lanes=2, pad_lanes_to=128, stop_ratio=0.5)
    return {
        "batch": (jax_map_from_routes(kps, **kw), map_from_routes(kps, device="cpu", **kw)),
        "shared": (jax_shared_map(kps, num_lanes=2, stop_ratio=0.5),
                   shared_map_from_routes(kps, num_lanes=2, stop_ratio=0.5, device="cpu")),
    }


@pytest.mark.parametrize("kind", ["batch", "shared"])
def test_route_towns_match(towns, kind):
    (jmap, jpaths), (tmap, paths) = towns[kind]
    assert paths == jpaths and all(len(p) >= 3 for p in paths)
    assert_fields_match(jmap, tmap, **MAP_TOL)
    valid = tmap.valid.numpy()
    if kind == "batch":
        # the pad grew from 128 to the next multiple of 128; the L's corner
        # is a junction, half the junctions all-way stops
        assert tmap.num_lanes == 256 and 128 < valid.sum() <= 256
        assert tuple(tmap.grid_lanes.shape[:2]) == (1792, 256)
        assert tuple(tmap.drivable_grid.shape) == (3584, 512)
        assert tmap.stop_lane.numpy().any() and tmap.is_junction.numpy().any()
    else:
        assert tmap.num_lanes == max(256, -(-int(valid.sum()) // 128) * 128)


def _plant_pair(tmp_path, dim, layers, heads, seed):
    jm = JaxPlanT(dim=dim, num_layers=layers, num_heads=heads)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 18, 7)),
                              jnp.zeros((1, 2)), jnp.zeros((1, 1)))
    path = str(tmp_path / f"plant{seed}.npz")
    jax_save_params(params, path)
    tm = PlanTModel(dim=dim, num_layers=layers, num_heads=heads, device="cpu")
    return jm, params, load_plant_weights(tm, path).eval()


def test_route_loop_with_plant_ego_and_attention_recognition(tmp_path, towns):
    """Reset on the route town (each scenario on its route's lane path, 24
    agents, one CBV slot, so the scorer picks among the rule's
    candidates), then five ticks from tick 26 with the PlanT ego (head dim
    32) and a PlanT recognizer (head dim 16), every pooled BV awake."""
    (jmap, paths), (tmap, tpaths) = towns["batch"]
    kw = dict(num_scenarios=S, num_agents=A, max_cbvs=C, seed=0)
    jstate, jcrit, jspec = JaxTrafficEnv(jmap, **kw).reset(
        routes=[jax_route_waypoints(jmap, p) for p in paths], lane_paths=paths)
    state, crit, spec = TrafficEnv(tmap, device="cpu", **kw).reset(
        routes=[route_waypoints(tmap, p) for p in tpaths], lane_paths=tpaths)
    assert_fields_match(jstate, state, atol=0.0)
    assert_fields_match(jcrit, crit, atol=0.0)
    assert_fields_match(jspec, spec, atol=0.0)

    je, jep, ego = _plant_pair(tmp_path, 64, 2, 2, seed=0)
    jr, jrp, recog = _plant_pair(tmp_path, 32, 2, 2, seed=1)
    t0 = 26
    jstate = jax_wake(jstate).replace(tick=jstate.tick + t0)
    state = wake_all_bvs(state)
    state = state.replace(tick=state.tick + t0)
    jwp = jax.jit(jax_plant_waypoints, static_argnums=0)
    for _ in range(5):
        jstate, jcrit = jax_env_step(jmap, jspec, jstate, jcrit,
                                     ego_traj=jwp(je, jep, jspec, jstate), max_cbvs=C,
                                     recog_model=jr, recog_params=jrp)
    state, crit, extras = rollout_chunk(None, tmap, spec, state, crit, max_cbvs=C, num_steps=5,
                                        with_policy=False, ego="plant", ego_model=ego,
                                        recog_model=recog, tick=t0)
    assert extras is None
    assert_fields_match(jstate, state, atol=1e-4, rtol=1e-4)
    assert_fields_match(jcrit, crit, atol=1e-4, rtol=1e-4)
    assert state.is_cbv.any()  # the attention recognizer promoted CBVs
