"""The port's CLI (run.py) and its configs, on the CPU.

Every JSON config under rift_tpu_torch/configs equals the JAX package's
YAML one (yaml.safe_load); `apply_overrides` and `load_config` give what
the JAX package's do. Then `run.main` at a tiny size (2 scenarios,
depth-1 model, a buffer of 8): one `train_cbv` episode on the grid town
of one block that fits once, checkpoints and saves a pretrain; an `eval`
episode on the straight town from that pretrain; and `eval --resume`,
which reads the statistics file back and runs only the missing episode.
"""

import glob
import json
import os

import numpy as np
import pytest
import yaml

from rift_tpu.utils import config as jax_config
from rift_tpu_torch import run
from rift_tpu_torch.utils import config
from torch_parity import one_torch_thread

CONFIGS = ("standard", "pluto", "rift_pluto", "grpo_pluto", "reinforce_pluto", "rs_pluto",
           "sft_pluto", "rtr_pluto", "ppo_pluto")


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


def test_run_train_cbv_then_eval_resume(tmp_path, capsys):
    out = str(tmp_path / "log")
    common = ["--ego_cfg", "behavior", "--cbv_cfg", "rift_pluto", "--device", "cpu",
              "--num_scenario", "2", "--num_agents", "10", "--out_dir", out,
              "encoder_depth=1", "decoder_depth=1", "canonical_tokens=true"]
    pre = str(tmp_path / "pretrain.npz")
    g = run.main(["--mode", "train_cbv", "--num_episodes", "1", "--max_ticks", "40",
                  "--blocks", "1", "--save_pretrain", pre, *common, "buffer_capacity=8",
                  "train.batch_size=4", "train.epochs=1", "train.warmup_epochs=0"])
    run_dir = os.path.join(out, "train_cbv", "behavior-rift_pluto-seed0")
    assert g.total_routes == 2 and os.path.exists(pre)
    assert os.listdir(os.path.join(run_dir, "model_ckpt")) == ["rift_pluto-episode_0"]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    assert len(metrics) == 1 and np.isfinite(metrics[0]["loss"])
    assert "fine-tune losses" in capsys.readouterr().out

    # the straight town builds in half the grid town's time; no CBV is
    # needed within the 20 ticks of an eval episode here
    eval_args = ["--mode", "eval", "--max_ticks", "20", "--town", "straight", "--pretrain", pre,
                 *common]
    run.main(["--num_episodes", "1", *eval_args])
    results = os.path.join(out, "eval", "behavior-rift_pluto-seed0", "simulation_results.json")
    with open(results) as f:
        first = json.load(f)["records"]
    g = run.main(["--num_episodes", "2", "--resume", *eval_args])
    with open(results) as f:
        records = json.load(f)["records"]
    assert g.total_routes == 4 and len(records) == 4 and records[:2] == first
    assert "episode 0" not in capsys.readouterr().out.split("loaded pretrain")[-1]
    with pytest.raises(KeyError, match="behavior"):
        run.main(["--mode", "eval", "--device", "cpu", "--out_dir", out])  # pdm_lite
    with pytest.raises(SystemExit):
        run.main(["--mode", "collect_data", "--device", "cpu"])
