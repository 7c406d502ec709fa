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
pdm_lite ego, legacy tokens, 2 walkers and 2 statics. The CLI on route
files is test_torch_cli_routes.py.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from rift_tpu.utils import config as jax_config
from rift_tpu_torch import run
from rift_tpu_torch.rollout import rollout_chunk
from rift_tpu_torch.sim.state import CLASS_STATIC, CLASS_WALKER
from rift_tpu_torch.utils import config
from torch_parity import one_torch_thread

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
    with pytest.raises(KeyError, match="no ego policy 'carla_autopilot'"):
        run.main(["--mode", "train_ego", "--ego_cfg", "carla_autopilot", "--device", "cpu",
                  "--out_dir", out])
    # --render is a flag of the CLI (its run: test_torch_render.py::test_cli_render)
    assert run.parse_args(["--mode", "eval", "--render"]).render


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
