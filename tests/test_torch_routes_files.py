"""Route files, their data loaders and compiled towns, against the JAX
package, on the CPU.

A small Bench2Drive-schema route file (torch_parity.write_route_file: a
straight route, an L with a corner and a crossing pair, each with weather
keyframes) is parsed by both packages: ids, towns, keypoints and weather,
with a subset; `Weather.at` and `visibility`; the Eval and Train data
loaders' batches under one seed; and `compile_town_from_npz` on an npz
written by the port's `save_npz`. The route towns built from the file and
a closed loop on one are test_torch_routes.py.

Tolerances: integer and bool fields exactly; the maps' float fields 1e-5
(the same numpy builders; the port's copy is bit-identical in practice).
"""

import numpy as np
import pytest

from rift_tpu.map import compile_town_from_npz as jax_compile_npz
from rift_tpu.map import grid_town_lanes
from rift_tpu.map import lanes_to_map_data as jax_lanes_to_map_data
from rift_tpu.scenario import routes as jax_routes
from rift_tpu_torch.map import compile_town_from_npz, lanes_to_map_data, save_npz
from rift_tpu_torch.scenario import routes
from torch_parity import assert_fields_match, one_torch_thread, write_route_file

MAP_TOL = dict(atol=1e-5, rtol=1e-5)


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
