"""The last two fine-tune keys' `_loss_fn` against the JAX policies' (as
test_torch_policies.py holds its three), `_teacher_label` exactly, and
the registries: the same keys, names and types, the same fused ego kinds,
trainable sets and optimizer settings as the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu import policies as jpolicies
from rift_tpu import run as jax_run
from rift_tpu_torch import policies, run
from test_torch_policies import CANONICAL_SMALL, CPU_MAP, FINE_TUNED, _given, loss_fn_matches_jax
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("key", FINE_TUNED[6:])
def test_loss_fn_matches_jax(key):
    loss_fn_matches_jax(key)


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
