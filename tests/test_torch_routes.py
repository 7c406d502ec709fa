"""Route files, route towns and a closed loop on one, against the JAX
package, on the CPU.

A small Bench2Drive-schema route file (torch_parity.write_route_file: a
straight route, an L with a corner and a crossing pair, each with weather
keyframes) is parsed by both packages: ids, towns, keypoints and weather,
with a subset; `Weather.at` and `visibility`; the Eval and Train data
loaders' batches under one seed. The route towns: every TensorMap field of
`map_from_routes` on the four routes (stop_ratio 0.5, a pad of 128 lanes
that grows to 256) and of `shared_map_from_routes`, with the lane paths
equal, and `compile_town_from_npz` on an npz written by the port's
`save_npz`. Then the slice as a whole: a reset on the route town with each
scenario on its route, and five ticks of the world with a small PlanT ego
(`rollout_chunk`, ego "plant") and attention recognition from tick 26 on
(recognition at ticks 28 and 30), against the JAX env_step fed the JAX
PlanT's waypoints, with the same weights (the JAX npz loaded strictly).

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

from rift_tpu.map import compile_town_from_npz as jax_compile_npz
from rift_tpu.map import grid_town_lanes
from rift_tpu.map import lanes_to_map_data as jax_lanes_to_map_data
from rift_tpu.map import route_waypoints as jax_route_waypoints
from rift_tpu.map.from_route import map_from_routes as jax_map_from_routes
from rift_tpu.map.from_route import shared_map_from_routes as jax_shared_map
from rift_tpu.models.plant import PlanTModel as JaxPlanT
from rift_tpu.models.plant import plant_ego_waypoints as jax_plant_waypoints
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import routes as jax_routes
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.scenario.env import env_step as jax_env_step
from rift_tpu.utils.params_io import save_params_npz as jax_save_params
from rift_tpu_torch.map import compile_town_from_npz, lanes_to_map_data, route_waypoints, save_npz
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


def _same_configs(a, b):
    assert [c.route_id for c in a] == [c.route_id for c in b]
    for x, y in zip(a, b):
        assert (x.town, x.repetition, x.name) == (y.town, y.repetition, y.name)
        np.testing.assert_array_equal(x.keypoints, y.keypoints)
        assert x.weather.keyframes == y.weather.keyframes


def test_route_file_and_weather_match(route_file):
    """parse_routes_file with and without a subset ("a-b,c"), group_by_town,
    and the weather's interpolation and visibility along the route."""
    for subset in ("", "1-2,4", "3"):
        got = routes.parse_routes_file(route_file, subset)
        _same_configs(jax_routes.parse_routes_file(route_file, subset), got)
    assert [c.route_id for c in got] == ["3"]
    assert [c.route_id for c in routes.parse_routes_file(route_file, "1-2,4")] == ["1", "2", "4"]
    with pytest.raises(ValueError):
        routes.parse_routes_file(route_file, "5")
    cfgs = routes.parse_routes_file(route_file)
    jcfgs = jax_routes.parse_routes_file(route_file)
    got, ref = routes.group_by_town(cfgs, 2), jax_routes.group_by_town(jcfgs, 2)
    assert sorted(got) == sorted(ref) == ["Town12-rep0", "Town12-rep1"]
    for key in got:
        _same_configs(ref[key], got[key])
    for c, j in zip(cfgs, jcfgs):
        for pct in (-5.0, 0.0, 37.5, 100.0, 140.0):
            assert c.weather.at(pct) == j.weather.at(pct)
            assert c.weather.visibility(pct) == j.weather.visibility(pct)
    assert cfgs[3].weather.visibility(50.0) < 1.0  # fog and rain cut it


def test_data_loaders_match(route_file):
    """Eval batches (non-overlapping routes, with resume) and Train batches
    (a seeded shuffle with replacement across epochs) of route ids."""
    cfgs = routes.parse_routes_file(route_file)
    jcfgs = jax_routes.parse_routes_file(route_file)
    ids = lambda batch: [c.route_id for c in batch]
    for resume in (0, 1):
        got = routes.EvalDataLoader(cfgs, 3, resume_index=resume)
        ref = jax_routes.EvalDataLoader(jcfgs, 3, resume_index=resume)
        assert len(got) == len(ref) == 4 - resume
        seq = [ids(got.sampler()) for _ in range(3)]
        assert seq == [ids(ref.sampler()) for _ in range(3)]
    assert seq[0] == ["2", "3"] and seq[1] == ["4"]  # 3 and 4 overlap
    got = routes.TrainDataLoader(cfgs, 2, seed=7)
    ref = jax_routes.TrainDataLoader(jcfgs, 2, seed=7)
    assert [ids(got.sampler()) for _ in range(6)] == [ids(ref.sampler()) for _ in range(6)]
    assert got.episode == ref.episode == 6


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


def test_compiled_town_matches(tmp_path):
    """lanes_to_map_data of a grid town (lights, stops, a crosswalk) equal
    in both packages; its npz, written by the port's save_npz, compiled by
    both: every TensorMap field."""
    lanes = grid_town_lanes(blocks=1, stop_ratio=0.5)
    cw = [np.array([[50.0, -8.0], [54.0, -8.0], [54.0, 8.0], [50.0, 8.0]])]
    md = lanes_to_map_data(lanes, cw)
    ref = jax_lanes_to_map_data(lanes, cw)
    assert sorted(md, key=str) == sorted(ref, key=str)
    assert {k: v for k, v in md.items() if k != "Crosswalks"} == {
        k: v for k, v in ref.items() if k != "Crosswalks"}
    path = save_npz(str(tmp_path / "TownFx_HD_map.npz"), md)
    tmap = compile_town_from_npz(path, device="cpu")
    assert_fields_match(jax_compile_npz(path), tmap, **MAP_TOL)
    assert tmap.light_group.numpy().max() >= 0 and tmap.stop_lane.numpy().any()


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
