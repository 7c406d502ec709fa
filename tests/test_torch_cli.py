"""The port's CLI (run.py) and its configs, on the CPU.

Every JSON config under rift_tpu_torch/configs equals the JAX package's
YAML one (yaml.safe_load); `apply_overrides` and `load_config` give what
the JAX package's do. Then `run.main` at a tiny size (2 scenarios,
depth-1 model, a buffer of 8): one `train_cbv` episode on the grid town
of one block that fits once, checkpoints, saves a pretrain and logs its
loss to the run's tracking directory; `train_cbv --resume --no_fused`,
which, as the JAX CLI, restores nothing and starts at episode 0 with the
fresh weights, and stores its samples in windows of FLUSH_K ticks; an
`eval` episode on the straight town from that pretrain, under another
`--seed`, whose CBV has the same weights (the config's seed makes them);
and `eval --resume`, which reads the statistics file back and runs only
the missing episode.
Then an `eval` with the JAX CLI's defaults (no ego, no override): the
pdm_lite ego, legacy tokens, 2 walkers and 2 statics. Then route files
(torch_parity.write_route_file), two runs that three tests read: an
`eval` of four routes in batches of 3 with the PlanT_medium ego and
attention recognition (records carry the route ids and weather; the
padded last batch makes one record); and one on the shared town with the
`--ego_weights` and `--recog_weights` npz files saved by the JAX
package's `save_params_npz`, with which the port's ego waypoints and
recognizer scores at tick 0 equal the JAX models' (1e-5).
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rift_tpu.models.plant import PlanTModel as JaxPlanT
from rift_tpu.models.plant import plant_ego_waypoints as jax_plant_waypoints
from rift_tpu.models.plant.train import plant_attn_scores as jax_attn_scores
from rift_tpu.sim.pid import PIDState as JaxPID
from rift_tpu.sim.pid import TrackerState as JaxTracker
from rift_tpu.sim.state import ScenarioSpec as JaxSpec
from rift_tpu.sim.state import SimState as JaxState
from rift_tpu.utils import config as jax_config
from rift_tpu.utils.params_io import save_params_npz as jax_save_params
from rift_tpu_torch import run
from rift_tpu_torch.models.plant import plant_ego_waypoints
from rift_tpu_torch.models.plant.train import plant_attn_scores
from rift_tpu_torch.rollout import rollout_chunk
from rift_tpu_torch.scenario.routes import parse_routes_file
from rift_tpu_torch.sim.state import CLASS_STATIC, CLASS_WALKER
from rift_tpu_torch.utils import config
from torch_parity import one_torch_thread, write_route_file

CONFIGS = ("standard", "pluto", "rift_pluto", "grpo_pluto", "reinforce_pluto", "rs_pluto",
           "sft_pluto", "rtr_pluto", "ppo_pluto", "pdm_lite", "plant", "ppo", "frea", "fppo_rs")


def test_configs_and_overrides_match_jax():
    names = sorted(os.path.basename(p)[:-5] for p in glob.glob(
        os.path.join(config.CONFIG_DIR, "*.json")))
    assert names == sorted(CONFIGS)
    for name in CONFIGS:
        with open(os.path.join(jax_config.CONFIG_DIR, f"{name}.yaml")) as f:
            assert config.load_config(name) == yaml.safe_load(f), name
    assert config.load_config("bc_pluto") == jax_config.load_config("bc_pluto")
    overrides = ["train.lr=2e-4", "encoder_depth=1", "+buffer_capacity=8", "name=abc",
                 "flag=true", "train.trainable_prefixes=[\"value_head\"]", "obs.radius=60.5"]
    base = config.load_config("rift_pluto")
    assert config.apply_overrides(base, overrides) == jax_config.apply_overrides(
        base, overrides)
    with pytest.raises(ValueError):
        config.apply_overrides(base, ["no_value"])
    assert config.merge(base, {"train": {"lr": 1.0}}) == jax_config.merge(
        base, {"train": {"lr": 1.0}})


def test_run_train_cbv_then_eval_resume(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "log")
    common = ["--ego_cfg", "behavior", "--cbv_cfg", "rift_pluto", "--device", "cpu",
              "--num_scenario", "2", "--num_agents", "10", "--out_dir", out,
              "encoder_depth=1", "decoder_depth=1", "canonical_tokens=true"]
    made = []  # (each CBV run.main builds, its weights as built)

    class Recorded(run.CBV_POLICY_LIST["rift_pluto"]):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append((self, {k: v.clone() for k, v in self.model.state_dict().items()}))

    monkeypatch.setitem(run.CBV_POLICY_LIST, "rift_pluto", Recorded)
    pre = str(tmp_path / "pretrain.npz")
    train_args = ["--mode", "train_cbv", "--blocks", "1", *common, "buffer_capacity=8",
                  "train.batch_size=4", "train.epochs=1", "train.warmup_epochs=0"]
    g = run.main(["--num_episodes", "1", "--max_ticks", "40", "--save_pretrain", pre,
                  *train_args])
    run_dir = os.path.join(out, "train_cbv", "behavior-rift_pluto-seed0")
    assert g.total_routes == 2 and os.path.exists(pre)
    assert os.listdir(os.path.join(run_dir, "model_ckpt")) == ["rift_pluto-episode_0"]
    (track_dir,) = glob.glob(os.path.join(run_dir, "runs", "train_cbv", "*"))
    with open(os.path.join(track_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    assert len(metrics) == 1 and np.isfinite(metrics[0]["loss"])
    assert "fine-tune losses" in capsys.readouterr().out

    # --resume restores nothing: episode 0 again, on the weights as built,
    # not the checkpoint's (the same run directory on the straight town,
    # which builds in half the time). The run is per tick (--no_fused):
    # its samples go to the buffer FLUSH_K ticks at a time, and before
    # tick 26 no CBV is recognized, so nothing is fitted
    windows = []
    flush = run.flush_pending
    monkeypatch.setattr(run, "flush_pending",
                        lambda store, pending: (windows.append(len(pending)),
                                                flush(store, pending)))
    run.main(["--num_episodes", "1", "--max_ticks", str(run.FLUSH_K + 1), "--resume",
              "--no_fused", *train_args, "--town", "straight"])
    assert "episode 0: DS" in capsys.readouterr().out
    assert [w for w in windows if w] == [run.FLUSH_K, 1]
    ckpt = torch.load(os.path.join(run_dir, "model_ckpt", "rift_pluto-episode_0"),
                      weights_only=True)
    (_, built), (resumed, resumed_built) = made
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, built[k]) and torch.equal(resumed_built[k], built[k]), k
    assert any(not torch.equal(v, built[k]) for k, v in ckpt.items())

    # the straight town builds in half the grid town's time; no CBV is
    # needed within the 20 ticks of an eval episode here. Under another
    # --seed, the CBV is built with the same weights (the config's seed)
    eval_args = ["--mode", "eval", "--max_ticks", "20", "--town", "straight", "--pretrain", pre,
                 "--seed", "7", *common]
    run.main(["--num_episodes", "1", *eval_args])
    for k, v in made[-1][1].items():
        assert torch.equal(v, built[k]), k
    results = os.path.join(out, "eval", "behavior-rift_pluto-seed7", "simulation_results.json")
    with open(results) as f:
        first = json.load(f)["records"]
    g = run.main(["--num_episodes", "2", "--resume", *eval_args])
    with open(results) as f:
        records = json.load(f)["records"]
    assert g.total_routes == 4 and len(records) == 4 and records[:2] == first
    assert "episode 0" not in capsys.readouterr().out.split("loaded pretrain")[-1]
    with pytest.raises(KeyError, match="'vad' is not ported"):
        run.main(["--mode", "train_ego", "--ego_cfg", "vad", "--device", "cpu",
                  "--out_dir", out])
    with pytest.raises(SystemExit):
        run.main(["--mode", "collect_data", "--device", "cpu"])


def test_run_eval_with_the_defaults(tmp_path, monkeypatch):
    """`run.main` in eval with no ego and no override: the pdm_lite ego
    computed in every chunk's tick loop, Pluto on legacy tokens (no map
    tokens), and 2 walkers and 2 static obstacles per scenario. Without a
    card and without --device cpu it raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run.main(["--mode", "eval", "--cbv_cfg", "rift_pluto"])
    calls = []

    def recorded(*args, **kw):
        state = args[3]
        calls.append(dict(kw, walkers=int((state.agent_class == CLASS_WALKER).sum()),
                          statics=int((state.agent_class == CLASS_STATIC).sum())))
        return rollout_chunk(*args, **kw)

    monkeypatch.setattr(run, "rollout_chunk", recorded)
    out = str(tmp_path / "log")
    g = run.main(["--mode", "eval", "--cbv_cfg", "rift_pluto", "--device", "cpu",
                  "--num_scenario", "2", "--num_agents", "12", "--num_episodes", "1",
                  "--max_ticks", "20", "--town", "straight", "--out_dir", out,
                  "encoder_depth=1", "decoder_depth=1"])
    assert g.total_routes == 2 and len(calls) == 1
    kw = calls[0]
    assert (kw["ego"], kw["canonical"], kw["map_tok"], kw["max_cbvs"]) == ("pdm", False, None, 2)
    assert (kw["walkers"], kw["statics"]) == (2 * 2, 2 * 2)
    assert os.path.exists(os.path.join(out, "eval", "pdm_lite-rift_pluto-seed0",
                                       "simulation_results.json"))


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
