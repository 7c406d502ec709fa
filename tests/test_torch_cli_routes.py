"""The port's CLI (run.py) on route files, on the CPU
(torch_parity.write_route_file), in two runs that three tests read: an
`eval` of four routes in batches of 3 with the PlanT_medium ego and
attention recognition (records carry the route ids and weather; the
padded last batch makes one record); and one on the shared town with the
`--ego_weights` and `--recog_weights` npz files saved by the JAX
package's `save_params_npz`, with which the port's ego waypoints and
recognizer scores at tick 0 equal the JAX models' (1e-5). The rest of the
CLI is test_torch_cli.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.models.plant import PlanTModel as JaxPlanT
from rift_tpu.models.plant import plant_ego_waypoints as jax_plant_waypoints
from rift_tpu.models.plant.train import plant_attn_scores as jax_attn_scores
from rift_tpu.sim.pid import PIDState as JaxPID
from rift_tpu.sim.pid import TrackerState as JaxTracker
from rift_tpu.sim.state import ScenarioSpec as JaxSpec
from rift_tpu.sim.state import SimState as JaxState
from rift_tpu.utils.params_io import save_params_npz as jax_save_params
from rift_tpu_torch import run
from rift_tpu_torch.models.plant import plant_ego_waypoints
from rift_tpu_torch.models.plant.train import plant_attn_scores
from rift_tpu_torch.rollout import rollout_chunk
from rift_tpu_torch.scenario.routes import parse_routes_file
from torch_parity import one_torch_thread, write_route_file


def _recorded_chunks(mp):
    """run.rollout_chunk recorded: each call's map, spec, state, tick and
    ego and recognizer models."""
    calls = []

    def recorded(model, tmap, spec, state, crit, **kw):
        calls.append(dict(kw, tmap=tmap, spec=spec, state=state))
        return rollout_chunk(model, tmap, spec, state, crit, **kw)

    mp.setattr(run, "rollout_chunk", recorded)
    return calls


def _to_jax(obj, cls):
    """A JAX SimState or ScenarioSpec holding a port container's values."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "tracker":
            pid = lambda p: JaxPID(*(jnp.asarray(x.numpy()) for x in (p.buf, p.ptr, p.count)))
            kw[f.name] = JaxTracker(pid(v.speed), pid(v.turn))
        else:
            kw[f.name] = None if v is None else jnp.asarray(v.numpy())
    return cls(**kw)


@pytest.fixture(scope="module")
def route_runs(tmp_path_factory):
    """The two route-file runs that the tests below read, each made once
    (a route town takes seconds of host numpy), on one file of four
    routes:
    - `routes`: eval in batches of 3 (routes 3 and 4 cross, so the loader
      puts 4 in a second batch, padded with itself), two episodes of 40
      ticks, each on a route town of 256 lanes, with the PlanT_medium ego
      (dim 512, 8 heads) and the PlanT scorer (dim 128, 4 layers, 4 heads;
      seeded, with a warning) recognizing CBVs from tick 26;
    - `shared`: eval on --shared_town, 2 scenarios, three episodes of 20
      ticks, with a small PlanT ego (dim 64, 2 layers, 2 heads) and the
      recognizer loaded by --ego_weights and --recog_weights from npz
      files that the JAX package's `save_params_npz` wrote.
    Each: the recorded chunks, the global statistics and the records."""
    tmp = tmp_path_factory.mktemp("route_runs")
    xml = write_route_file(tmp / "routes.xml")
    common = ["--mode", "eval", "--routes", xml, "--cbv_recog", "attention", "--device", "cpu",
              "encoder_depth=1", "decoder_depth=1"]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        calls = _recorded_chunks(mp)
        out = str(tmp / "log")
        with pytest.warns(UserWarning, match="recog_weights"):
            g = run.main(["--ego_cfg", "plant", "--num_scenario", "3", "--num_agents", "12",
                          "--num_episodes", "2", "--max_ticks", "40", "--out_dir", out,
                          *common])
        with open(os.path.join(out, "eval", "plant-rift_pluto-seed0",
                               "simulation_results.json")) as f:
            runs["routes"] = dict(calls=list(calls), g=g, records=json.load(f)["records"],
                                  xml=xml)

        dims = {"dim": 64, "num_layers": 2, "num_heads": 2}
        ego_cfg = tmp / "plant_small.json"
        ego_cfg.write_text(json.dumps({"policy": "plant", **dims}))
        toks = (jnp.zeros((1, 18, 7)), jnp.zeros((1, 2)), jnp.zeros((1, 1)))
        jego, jrecog = JaxPlanT(**dims), JaxPlanT(dim=128, num_layers=4, num_heads=4)
        ego_params = jax.jit(jego.init)(jax.random.PRNGKey(0), *toks)
        recog_params = jax.jit(jrecog.init)(jax.random.PRNGKey(1), *toks)
        jax_save_params(ego_params, str(tmp / "ego.npz"))
        jax_save_params(recog_params, str(tmp / "recog.npz"))
        calls.clear()
        g = run.main(["--shared_town", "--ego_cfg", str(ego_cfg), "--ego_weights",
                      str(tmp / "ego.npz"), "--recog_weights", str(tmp / "recog.npz"),
                      "--num_scenario", "2", "--num_agents", "10", "--num_episodes", "3",
                      "--max_ticks", "20", "--out_dir", str(tmp / "log_shared"), *common])
        runs["shared"] = dict(calls=list(calls), g=g, jax=(jego, ego_params, jrecog,
                                                           recog_params))
    return runs


def test_run_routes_with_plant_ego_and_attention(route_runs):
    """The `routes` run: two episodes, each on its batch's route town, the
    first batch's the town built up front. Four records: the route ids,
    each route's weather at its completion, and each scenario's visibility
    from its route's weather."""
    r = route_runs["routes"]
    calls = r["calls"]
    assert r["g"].total_routes == 4 and len(calls) == 4
    ego, recog = calls[0]["ego_model"], calls[0]["recog_model"]
    assert (ego.dim, ego.num_layers, ego.layer0.Attention_0.num_heads) == (512, 8, 8)
    assert (recog.dim, recog.num_layers, recog.layer0.Attention_0.num_heads) == (128, 4, 4)
    assert all(c["ego"] == "plant" and c["recog_model"] is recog for c in calls)
    assert [c["tick"] for c in calls] == [0, 20, 0, 20]
    tmaps = [c["tmap"] for c in calls]
    assert tmaps[0] is tmaps[1] and tmaps[1] is not tmaps[2]
    assert all(t.num_lanes == 256 and (t.light_group == -1).all() for t in tmaps)
    cfgs = parse_routes_file(r["xml"])
    vis = calls[2]["spec"].visibility.tolist()
    assert vis == pytest.approx([cfgs[3].weather.visibility()] * 3)
    assert [rec["route_id"] for rec in r["records"]] == [c.name for c in cfgs]
    for rec in r["records"]:
        cfg = next(c for c in cfgs if c.name == rec["route_id"])
        assert rec["weather"] == pytest.approx(cfg.weather.at(rec["route_completion"]))


def test_run_shared_town(route_runs):
    """The `shared` run: one town of all four routes, built up front and
    kept for every episode; each episode's scenarios drive their routes'
    lane paths on it (the crossing pair through its shared junction)."""
    r = route_runs["shared"]
    calls = r["calls"]
    assert r["g"].total_routes == 4 and len(calls) == 3
    assert calls[0]["tmap"] is calls[1]["tmap"] is calls[2]["tmap"]
    assert calls[0]["tmap"].is_junction.any()


def test_run_plant_weights_from_jax(route_runs):
    """The `shared` run's --ego_weights and --recog_weights: the ego and
    the recognizer load them strictly, and on the first chunk's scene
    (tick 0) the port's waypoints and scores equal the JAX models' with
    those params."""
    jego, ego_params, jrecog, recog_params = route_runs["shared"]["jax"]
    first = route_runs["shared"]["calls"][0]
    assert first["ego_model"].dim == 64 and first["recog_model"].dim == 128
    spec, state = first["spec"], first["state"]
    jspec, jstate = _to_jax(spec, JaxSpec), _to_jax(state, JaxState)
    with torch.no_grad():
        np.testing.assert_allclose(
            plant_ego_waypoints(first["ego_model"], spec, state).numpy(),
            np.asarray(jax_plant_waypoints(jego, ego_params, jspec, jstate)), atol=1e-5, rtol=1e-5)
        got = plant_attn_scores(first["recog_model"], spec, state).numpy()
    ref = np.asarray(jax.jit(jax_attn_scores, static_argnums=0)(jrecog, recog_params, jspec,
                                                                  jstate))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], atol=1e-5, rtol=1e-5)
