"""The port's Pluto fine-tuning zoo (policies.py) against the JAX package's,
on the CPU.

Each fine-tune key's `_loss_fn` against the JAX policy's on the same fixed
model outputs: both policies get a stub model that returns the outputs
(the JAX stub's `apply(params, features)` returns `params`), so no model
compiles, and the gradients are taken w.r.t. those outputs; values and
gradients within 1e-5 (f32 sums over a few hundred candidates).
`_teacher_label` exactly. The registries hold the ported keys and name
them when asked for another; the trainable sets and optimizer settings
are the JAX policies', and the defaults (the token convention, the
Runner's fields, the CLI's flags) the JAX package's. (The pretrain npz
round trip between the packages is in test_torch_pluto.py, on its seeded
model.)
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu import policies as jpolicies
from rift_tpu.runner import RunnerConfig as JaxRunnerConfig
from rift_tpu import run as jax_run
from rift_tpu_torch import policies, run
from rift_tpu_torch.runner import Runner, RunnerConfig
from rift_tpu_torch.utils.config import apply_overrides, load_config
from torch_parity import one_torch_thread

BS, R, M, F, P = 6, 3, 4, 80, 5
FINE_TUNED = ("rift_pluto", "grpo_pluto", "reinforce_pluto", "rs_pluto", "sft_pluto",
              "bc_pluto", "rtr_pluto", "ppo_pluto")
CPU_MAP = types.SimpleNamespace(device=torch.device("cpu"))  # what a policy reads
SMALL = {"encoder_depth": 1, "decoder_depth": 1}
CANONICAL_SMALL = {**SMALL, "canonical_tokens": True}


def _given(seed=0):
    """(model outputs, reference outputs, batch) as numpy, from a seed."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    valid_pts = r.random((BS, R, P)) < 0.8
    valid_pts[:, 1:][r.random((BS, R - 1)) < 0.3] = False  # padded lines
    valid_pts[:, 0, 0] = True
    r_pad = ~valid_pts.any(-1)

    def outs():
        prob = np.where(r_pad[:, :, None], -1e6, f(BS, R, M)).astype(np.float32)
        traj = np.cumsum(0.8 + 0.3 * f(BS, R, M, F, 6), axis=3).astype(np.float32)
        return {"probability": prob, "trajectory": traj,
                "output_ref_free_trajectory": np.cumsum(0.8 + 0.3 * f(BS, F, 3), 1),
                "value": f(BS)}

    out, ref = outs(), outs()
    batch = {
        "features": {"reference_line": {"valid_mask": valid_pts}},
        "old_logits": f(BS, R, M), "advantage": f(BS, R, M),
        "valid": r.random((BS, R, M)) < 0.7, "chosen_idx": r.integers(0, R * M, BS),
        "teacher_speed": 5.0 + f(BS), "teacher_pos": 30.0 + 3.0 * f(BS, 2),
        "teacher_traj": np.cumsum(0.8 + 0.3 * f(BS, F, 2), 1).astype(np.float32),
        "value": f(BS), "ret": f(BS), "ret_shaped": f(BS), "gae": f(BS),
        "gae_valid": r.random(BS) < 0.8,
    }
    return out, ref, batch


def _tree(x, fn):
    return {k: _tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


class _JaxStub:
    def apply(self, params, features):
        return params


@pytest.mark.parametrize("key", FINE_TUNED)
def test_loss_fn_matches_jax(key):
    out, ref, batch = _given()
    jpol = jpolicies.CBV_POLICY_LIST[key](None, {})
    jpol.model = _JaxStub()
    jpol.ref_params = _tree(ref, jnp.asarray)
    jbatch = _tree(batch, jnp.asarray)
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda o: jpol._loss_fn(o, jbatch, None)))(
        _tree(out, jnp.asarray))

    pol = policies.CBV_POLICY_LIST[key](CPU_MAP, CANONICAL_SMALL)
    touts = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in out.items()}
    pol.ref_model = lambda features: _tree(ref, torch.from_numpy)
    loss = pol._loss_fn(lambda features: dict(touts), _tree(batch, torch.from_numpy))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    for k, t in touts.items():
        g = torch.zeros_like(t) if t.grad is None else t.grad
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_teacher_label_and_registry():
    out, _, batch = _given(1)
    r_pad = ~batch["features"]["reference_line"]["valid_mask"].any(-1)
    for pos in (batch["teacher_pos"], None):
        want = jpolicies._teacher_label(
            jnp.asarray(out["probability"]), jnp.asarray(r_pad), jnp.asarray(out["trajectory"]),
            jnp.asarray(batch["teacher_speed"]), None if pos is None else jnp.asarray(pos))
        got = policies._teacher_label(
            torch.from_numpy(out["probability"]), torch.from_numpy(r_pad),
            torch.from_numpy(out["trajectory"]), torch.from_numpy(batch["teacher_speed"]),
            None if pos is None else torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    assert set(policies.CBV_POLICY_LIST) == {"standard", "pluto", *FINE_TUNED, "ppo", "frea",
                                             "fppo_rs"} == set(jpolicies.CBV_POLICY_LIST)
    assert set(policies.EGO_POLICY_LIST) == set(jpolicies.EGO_POLICY_LIST)
    with pytest.raises(KeyError, match="pdm_lite"):
        policies.EGO_POLICY_LIST["carla_autopilot"]
    with pytest.raises(KeyError, match="sparsedrive"):
        policies.EGO_POLICY_LIST["e2e"]
    for name, cls in policies.CBV_POLICY_LIST.items():
        assert cls.name == jpolicies.CBV_POLICY_LIST[name].name == name
        assert cls.type == jpolicies.CBV_POLICY_LIST[name].type
    for name, cls in policies.EGO_POLICY_LIST.items():
        assert cls.name == jpolicies.EGO_POLICY_LIST[name].name == name
        assert cls.type == jpolicies.EGO_POLICY_LIST[name].type
        assert run.FUSED_EGO_KIND.get(name) == jax_run.FUSED_EGO_KIND.get(name)
    for key in ("pluto", "rift_pluto", "ppo_pluto", "bc_pluto"):
        trainable = policies.CBV_POLICY_LIST[key](CPU_MAP, CANONICAL_SMALL)
        jtrain = jpolicies.CBV_POLICY_LIST[key](None, {})
        if key != "pluto":
            assert trainable.train_cfg.trainable_prefixes == jtrain.train_cfg.trainable_prefixes
            assert trainable.train_cfg.lr == jtrain.train_cfg.lr
            assert trainable.train_cfg.grad_clip == jtrain.train_cfg.grad_clip
        assert trainable.execute_teacher == jtrain.execute_teacher


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
