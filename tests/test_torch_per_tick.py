"""The port's per-tick loop on the CPU: against the fused loop (40 ticks
of a depth-1 Pluto on legacy tokens with the PDM ego, CBVs from rule
recognition after tick 25; every state and criteria field bit-equal), the
`expert_disturb` ego's noise (mean ~0, std ~0.3 against `expert`, a new
draw each tick), and the CLI at its smallest size: `--mode train_ego
--ego_cfg ppo` and a classic `train_cbv` (`frea`, with its warning; its
checkpoint then loaded back by `cfg['weights']`); the JAX package's
`read_metrics` and the port's `list_runs` read the run directory the
port wrote. The JAX parity of these paths is test_torch_classic.py; the
per-tick Pluto `train_cbv --no_fused` is test_torch_cli.py's resume run.
"""

import glob
import os
import types

import numpy as np
import pytest
import torch

from rift_tpu.utils.tracking import read_metrics as jax_read_metrics
from rift_tpu_torch import policies, run
from rift_tpu_torch.map import make_straight_town
from rift_tpu_torch.scenario import TrafficEnv
from rift_tpu_torch.utils.tracking import list_runs
from torch_parity import assert_fields_match, one_torch_thread

CPU = types.SimpleNamespace(device=torch.device("cpu"))  # a map for map-free policies


@pytest.fixture(scope="module")
def town():
    return make_straight_town(length=600.0, num_lanes=2, device="cpu")


def test_per_tick_loop_equals_fused(town):
    """40 ticks of the PDM ego and a depth-1 Pluto (legacy tokens; CBVs
    from rule recognition after tick 25) through the per-tick loop and the
    fused one, from one reset: every state and criteria field equal."""
    env = TrafficEnv(town, num_scenarios=2, num_agents=10, max_cbvs=2, seed=3, device="cpu")
    ego = policies.PDMLiteEgo(town)
    cbv = policies.RIFTPlutoPolicy(town, {"max_cbvs": 2, "encoder_depth": 1,
                                          "decoder_depth": 1})
    state0, crit0, spec = env.reset()
    loops = []
    for loop in (run.run_episode, run.run_episode_fused):
        env.tick = 0
        with torch.no_grad():
            loops.append(loop(env, ego, cbv, state0, crit0, spec, 40))
    (st, cr), (fst, fcr) = loops
    assert env.tick == 40 and bool(st.is_cbv.any())
    assert_fields_match(fst, st, atol=0.0)
    assert_fields_match(fcr, cr, atol=0.0)


def test_expert_disturb_noise(town):
    env = TrafficEnv(town, num_scenarios=4, num_agents=8, device="cpu")
    state, _, spec = env.reset()
    expert, disturb = policies.ExpertEgo(town), policies.ExpertDisturbEgo(town, {})
    noise = torch.stack([disturb.act(spec, state) - expert.act(spec, state) for _ in range(5)])
    assert noise.shape == (5, 4, 30, 2)
    assert abs(noise.mean().item()) < 0.03 and abs(noise.std().item() - 0.3) < 0.02
    assert not torch.equal(noise[0], noise[1])  # one draw a tick


def test_cli_train_ego_and_classic_train_cbv(tmp_path, capsys):
    out = str(tmp_path / "log")
    common = ["--device", "cpu", "--town", "straight", "--num_scenario", "2",
              "--num_agents", "8", "--num_episodes", "1", "--out_dir", out]
    run.main(["--mode", "train_ego", "--ego_cfg", "ppo", "--cbv_cfg", "ppo",
              "--max_ticks", "20", *common])
    tag_dir = os.path.join(out, "train_ego", "ppo-ppo-seed0")
    assert os.listdir(os.path.join(tag_dir, "model_ckpt")) == ["ego_ppo-episode_0"]
    assert "ego PPO losses" in capsys.readouterr().out
    (run_dir,) = glob.glob(os.path.join(tag_dir, "runs", "train_ego", "*"))
    rows = jax_read_metrics(run_dir)  # the JAX package's reader
    assert [r["_step"] for r in rows] == [0] and np.isfinite(rows[0]["loss"])
    ((project, listed, meta, summary),) = list_runs(os.path.join(tag_dir, "runs"))
    assert (project, listed, meta["status"]) == ("train_ego", run_dir, "finished")
    assert summary["total_routes"] == 2

    with pytest.warns(UserWarning, match="frea"):
        run.main(["--mode", "train_cbv", "--ego_cfg", "behavior", "--cbv_cfg", "frea",
                  "--max_ticks", "60", *common])
    ckpt = os.path.join(out, "train_cbv", "behavior-frea-seed0", "model_ckpt")
    assert os.listdir(ckpt) == ["cbv_frea-episode_0"]
    assert "classic CBV PPO losses" in capsys.readouterr().out
    frea = policies.FREAPolicy(CPU, {"weights": ckpt})
    saved = torch.load(os.path.join(ckpt, "cbv_frea-episode_0"), weights_only=True)
    for name, p in frea.ppo.actor.state_dict().items():
        assert torch.equal(p, saved["actor"][name]), name

