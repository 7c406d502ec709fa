"""The port's defaults against the JAX package's: the token convention of
the Pluto policies, the RunnerConfig fields the two share, and the CLI's
flags."""

import dataclasses

from rift_tpu import policies as jpolicies
from rift_tpu.runner import RunnerConfig as JaxRunnerConfig
from rift_tpu_torch import policies, run
from rift_tpu_torch.runner import Runner, RunnerConfig
from rift_tpu_torch.utils.config import apply_overrides, load_config
from test_torch_policies import CPU_MAP, SMALL
from torch_parity import one_torch_thread  # noqa: F401


def test_defaults_equal_the_jax_defaults():
    """The JAX package runs Pluto on legacy per-CBV tokens unless a config
    sets `canonical_tokens` (no shipped config does) or the Runner's
    `canonical`; so does the port, which computes map tokens only for
    canonical tokens. The fields the two RunnerConfigs share default
    alike, and the port's own (ego, walkers, statics) default to what the
    JAX Runner runs. The CLI's defaults are the JAX CLI's: the pdm_lite
    ego and, in eval, 2 walkers and 2 statics (-1: by mode)."""
    jpol = jpolicies.CBV_POLICY_LIST["rift_pluto"](None, {})
    assert "canonical_tokens" not in load_config("rift_pluto")
    pol = policies.CBV_POLICY_LIST["rift_pluto"](CPU_MAP, {**load_config("rift_pluto"), **SMALL})
    assert pol.canonical is jpol.canonical is False and pol.map_tokens() is None
    cfg = apply_overrides(load_config("rift_pluto"), ["canonical_tokens=true"])
    pol = policies.CBV_POLICY_LIST["rift_pluto"](CPU_MAP, {**cfg, **SMALL})
    assert pol.trainable and pol.canonical is True

    assert RunnerConfig().canonical is JaxRunnerConfig().canonical is False
    jfields = {f.name: f for f in dataclasses.fields(JaxRunnerConfig)}
    own = set()
    for f in dataclasses.fields(RunnerConfig):
        if f.name not in jfields:
            own.add(f.name)
        elif f.name != "train":
            assert f.default == jfields[f.name].default, f.name
    assert own == {"ego", "num_walkers", "num_statics"}
    cfg = RunnerConfig()
    assert (cfg.ego, cfg.num_walkers, cfg.num_statics) == ("rule", 0, 0)
    runner = Runner(CPU_MAP, RunnerConfig(encoder_depth=1, decoder_depth=1), device="cpu")
    assert runner._map_tokens() is None and runner.env.num_walkers == 0

    args = run.parse_args([])
    assert (args.mode, args.ego_cfg, args.cbv_cfg) == ("eval", "pdm_lite", "rift_pluto")
    assert (args.num_walkers, args.num_statics, args.overrides) == (-1, -1, [])
