"""rift_tpu_torch's Pluto planner against rift_tpu's, on the same weights
and the same scene.

The JAX weights are made from a numpy seed in the shape of the flax param
tree, written with `save_params_npz` and loaded into the torch model with
the strict `load_jax_params`. Everything runs in f32. Tolerances: single
modules 1e-4 (f32 products a few hundred deep, summed in another order);
the whole model and the act step 1e-3 (atol and rtol), through ~30 chained
layers and layer norms; integer outputs (masks, chosen candidates,
feature indices) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.models.pluto import PlutoModel as JaxPluto
from rift_tpu.models.pluto import build_cbv_features as jax_build_features
from rift_tpu.models.pluto.layers import Attention as JaxAttention
from rift_tpu.models.pluto.layers import HistoryEncoder as JaxHistoryEncoder
from rift_tpu.models.pluto.layers import PointsEncoder as JaxPointsEncoder
from rift_tpu.models.pluto.policy import canonical_map_tokens as jax_map_tokens
from rift_tpu.models.pluto.policy import pluto_cbv_act as jax_act
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import cbv_slot_assignment as jax_slots
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.utils.params_io import load_params_npz as jax_load_npz
from rift_tpu.utils.params_io import merge_params as jax_merge
from rift_tpu.utils.params_io import save_params_npz
from rift_tpu_torch.policies import CBV_POLICY_LIST
from rift_tpu_torch.models.pluto import (
    PlutoModel,
    build_cbv_features,
    canonical_map_tokens,
    pluto_cbv_act,
)
from rift_tpu_torch.scenario import cbv_slot_assignment
from rift_tpu_torch.utils.params_io import (
    flatten_params,
    jax_flat_params,
    load_jax_params,
    load_params_npz,
    save_params_npz as torch_save_npz,
)
from torch_parity import (
    map_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
    stepped_scene,
)

S, A, C = 2, 6, 2
DEPTH = 1


def _flatten_batch(feats, shared):
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), feats)
    flat = dict(flat)
    flat["shared"] = {**shared, "scen_idx": jnp.repeat(jnp.arange(S), C)}
    return flat


def _seeded_params(shapes, seed=0):
    """numpy-seeded weights in the flax tree's shapes: unit-variance fan-in
    scaling for matrices, small offsets for biases, scales near 1."""
    r = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, sd in leaves:
        name = str(path[-1].key)
        s = sd.shape
        if name.endswith("scale"):
            a = 1.0 + 0.1 * r.normal(size=s)
        elif name.endswith(("bias", "_b", "b1", "b2")) or len(s) == 1:
            a = 0.1 * r.normal(size=s)
        else:
            a = r.normal(size=s) / np.sqrt(np.prod(s[:-1]))
        out.append(jnp.asarray(a, jnp.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    t = torch.from_numpy(a.copy())
    return t.long() if a.dtype.kind in "iu" else t


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jmap = jax_grid_town(blocks=1, num_lanes=2)
    env = JaxTrafficEnv(jmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=3)
    jstate, crit, jspec = env.reset()
    # populate history: four steps, by the port's env
    jstate, crit = stepped_scene(jmap, jstate, crit, jspec, 4, C)
    # force CBVs on slot 1 (recognition has a 25-tick warmup)
    jstate = jax_wake(jstate)
    jstate = jstate.replace(
        is_cbv=jstate.is_cbv.at[:, 1].set(jstate.alive[:, 1]),
        goal=jstate.goal.at[:, 1].set(jstate.pos[:, 1] + jnp.array([60.0, 0.0])),
        goal_valid=jstate.goal_valid.at[:, 1].set(jstate.alive[:, 1]),
    )
    jmodel = JaxPluto(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=jnp.float32)
    slots = jax_slots(jstate.is_cbv, C)
    feats, valid, shared = jax_build_features(
        jmap, jstate, slots, jspec, canonical=True
    )
    batch = _flatten_batch(feats, shared)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    params = _seeded_params(shapes)
    path = str(tmp_path_factory.mktemp("params") / "pluto.npz")
    save_params_npz(params, path)
    flat = flatten_params(load_params_npz(path))

    model = PlutoModel(
        encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32, device="cpu"
    )
    load_jax_params(model, flat)
    tmap = map_from_jax(jmap)  # equal to the port's grid town, bit for bit (test_torch_map)
    return dict(
        jmap=jmap, jstate=jstate, jspec=jspec, jmodel=jmodel, params=params,
        batch=batch, feats=feats, flat=flat, model=model, tmap=tmap,
        state=state_from_jax(jstate), spec=spec_from_jax(jspec),
    )


def test_load_jax_params_is_exact_and_strict(world):
    model, flat = world["model"], world["flat"]
    p = {k: v.detach() for k, v in model.named_parameters()}
    # Dense kernel [in, out] -> Linear weight [out, in]
    k = flat["params/enc0/Dense_0/kernel"]
    np.testing.assert_array_equal(p["enc0.Dense_0.weight"].numpy(), k.T)
    # packed projection kernel [in, H, Dh] / bias [H, Dh]
    k = flat["params/planning_decoder/layer0/r2r/q/kernel"]
    np.testing.assert_array_equal(
        p["planning_decoder.layer0.r2r.q.weight"].numpy(), k.reshape(k.shape[0], -1).T
    )
    # the automatic `flat` child of a batched PointsEncoder
    np.testing.assert_array_equal(
        p["planning_decoder.r_encoder.Dense_2.kernel"].numpy(),
        flat["params/planning_decoder/r_encoder/flat/Dense_2/kernel"],
    )
    np.testing.assert_array_equal(
        p["enc_norm.weight"].numpy(), flat["params/enc_norm/scale"]
    )
    assert len(flat) == len(p)

    fresh = lambda: PlutoModel(
        encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32, device="cpu"
    )
    missing = dict(flat)
    del missing["params/pos_emb/w1"]
    with pytest.raises(KeyError, match="left unset"):
        load_jax_params(fresh(), missing)
    extra = dict(flat)
    extra["params/planning_decoder/bogus/kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="bogus"):
        load_jax_params(fresh(), extra)
    wrong = dict(flat)
    wrong["params/enc_norm/scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="enc_norm"):
        load_jax_params(fresh(), wrong)


def _sub(params, *path):
    p = params["params"]
    for k in path:
        p = p[k]
    return {"params": p}


def test_points_encoder_matches(world):
    r = np.random.default_rng(5)
    x = r.normal(0, 2.0, (2, 3, 30, 6)).astype(np.float32)
    mask = r.random((2, 3, 30)) < 0.7
    mask[0, 1] = False
    mod = JaxPointsEncoder(128, dtype=jnp.float32)
    ref = jax.jit(mod.apply)(
        _sub(world["params"], "planning_decoder", "r_encoder"),
        jnp.asarray(x), jnp.asarray(mask),
    )
    got = world["model"].planning_decoder.r_encoder(
        torch.from_numpy(x), torch.from_numpy(mask)
    )
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("kind", ["r2r", "m2m", "cross"])
def test_attention_module_matches(world, kind):
    r = np.random.default_rng(6)
    q = r.normal(0, 1, (3, 12, 128)).astype(np.float32)
    kv = r.normal(0, 1, (3, 9, 128)).astype(np.float32)
    pad = r.random((3, 9)) < 0.3
    mod = JaxAttention(128, 4, dtype=jnp.float32)
    prm = _sub(world["params"], "planning_decoder", "layer0", kind)
    tmod = getattr(world["model"].planning_decoder.layer0, kind)
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    if kind == "r2r":  # self-attention: one merged q/k/v projection
        ref = jax.jit(lambda p, a: mod.apply(p, a))(prm, jnp.asarray(q))
        got = tmod(tq)
    elif kind == "m2m":  # q and k share an input
        ref = jax.jit(lambda p, a, b: mod.apply(p, a, a, b))(
            prm, jnp.asarray(q), jnp.asarray(q[:, ::-1])
        )
        got = tmod(tq, tq, tq.flip(1), merge="qk")
    else:
        ref = jax.jit(lambda p, a, b, m: mod.apply(p, a, b, b, key_padding_mask=m))(
            prm, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(pad)
        )
        got = tmod(tq, tkv, tkv, key_padding_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4)


def test_history_encoder_matches(world):
    x = np.asarray(world["batch"]["shared"]["hist_feat"]).reshape(-1, 20, 9)
    x = x + np.random.default_rng(7).normal(0, 0.5, x.shape).astype(np.float32)
    mod = JaxHistoryEncoder(embed_dim=32, dtype=jnp.float32)
    ref = jax.jit(mod.apply)(
        _sub(world["params"], "AgentEncoder_0", "HistoryEncoder_0"), jnp.asarray(x)
    )
    got = world["model"].AgentEncoder_0.HistoryEncoder_0(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4)


def test_features_match(world):
    slots = cbv_slot_assignment(world["state"].is_cbv, C)
    feats, valid, shared = build_cbv_features(
        world["tmap"], world["state"], slots, world["spec"], canonical=True
    )
    jf = world["feats"]
    for g in jf:
        for k in (jf[g] if isinstance(jf[g], dict) else [None]):
            a = jf[g][k] if k else jf[g]
            b = feats[g][k] if k else feats[g]
            a = np.asarray(a)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b.numpy(), a, err_msg=f"{g}.{k}")
            else:
                np.testing.assert_allclose(b.numpy(), a, atol=1e-4, err_msg=f"{g}.{k}")
    for k, v in shared.items():
        np.testing.assert_allclose(
            v.numpy(), np.asarray(world["batch"]["shared"][k]), atol=1e-5, err_msg=k
        )


def test_pluto_model_forward_matches(world):
    """Full forward on the canonical batch, aux head included, with
    ppo_pluto's value head (the critic MLP on the centre-agent token,
    seeded apart from the fixture's weights)."""
    sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    head = {"Dense_0": {"kernel": sds(128, 128), "bias": sds(128)},
            "LayerNorm_0": {"scale": sds(128), "bias": sds(128)},
            "Dense_1": {"kernel": sds(128, 1), "bias": sds(1)}}
    params = {"params": {**world["params"]["params"],
                         "value_head": _seeded_params(head, seed=1)}}
    jmodel = JaxPluto(encoder_depth=DEPTH, decoder_depth=DEPTH, value_head=True,
                      dtype=jnp.float32)
    ref = jax.jit(jmodel.apply)(params, world["batch"])
    model = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, value_head=True,
                       dtype=torch.float32, device="cpu")
    load_jax_params(model, flatten_params(params))
    with torch.no_grad():
        got = model(_to_torch(world["batch"]))
    assert got["value"].shape == (S * C,)
    for k in ("probability", "trajectory", "output_ref_free_trajectory", "hidden",
              "output_prediction", "value"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), atol=1e-3, rtol=1e-3, err_msg=k
        )


def test_pluto_cbv_act_matches(world):
    jtok = jax_map_tokens(world["jmodel"], world["params"], world["jmap"])
    tok = canonical_map_tokens(world["model"], world["tmap"])
    np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), atol=1e-4)
    ref = jax_act(
        world["jmodel"], world["params"], world["jmap"], world["jspec"],
        world["jstate"], max_cbvs=C, canonical=True, map_tok=jtok,
    )
    got = pluto_cbv_act(
        world["model"], world["tmap"], world["spec"], world["state"],
        max_cbvs=C, canonical=True, map_tok=tok,
    )
    mask = np.asarray(ref["mask"])
    assert mask.any()
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_allclose(
        got["traj"].numpy()[mask], np.asarray(ref["traj"])[mask], atol=1e-3, rtol=1e-3
    )
    slots = np.asarray(ref["cbv_slots"])
    np.testing.assert_array_equal(got["cbv_slots"].numpy(), slots)
    np.testing.assert_array_equal(
        got["chosen_idx"].numpy()[slots >= 0], np.asarray(ref["chosen_idx"])[slots >= 0]
    )


def test_pluto_model_bf16_close(world):
    """bf16 compute, as the planner runs on the card: the port's dtype flow
    (bf16 matmuls, f32 norms and softmax) tracks the JAX package's. With 8
    mantissa bits per rounding through ~30 layers, outputs of magnitude ~3
    agree within 0.08 (observed: 0.03)."""
    jmodel = JaxPluto(encoder_depth=DEPTH, decoder_depth=DEPTH)
    ref = jax.jit(jmodel.apply)(world["params"], world["batch"])
    model = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, device="cpu")
    load_jax_params(model, world["flat"])
    with torch.no_grad():
        got = model(_to_torch(world["batch"]))
    for k in ("probability", "trajectory", "hidden"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), atol=8e-2, rtol=0, err_msg=k
        )


def test_pretrain_npz_moves_between_packages(world, tmp_path):
    """Port -> JAX: the port's `save_params_npz` of the seeded model holds
    exactly the JAX param tree's keys, shapes and values, read by the JAX
    package's `load_params_npz` and taken whole by its `merge_params`.
    JAX -> port: the JAX package's npz loads into ppo_pluto's model
    (`load_pretrain`, merge semantics), whose value head, absent from the
    file, keeps its init and is exported under the JAX names."""
    path = str(tmp_path / "port.npz")
    torch_save_npz(world["model"], path)
    got = flatten_params(jax_load_npz(path))
    want = flatten_params(world["params"])
    assert sorted(got) == sorted(want)
    for k, v in flatten_params(jax_merge(world["params"], jax_load_npz(path))).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]), err_msg=k)

    pol = CBV_POLICY_LIST["ppo_pluto"](world["tmap"], {"encoder_depth": DEPTH,
                                                       "decoder_depth": DEPTH,
                                                       "canonical_tokens": True})
    head = {n: p.detach().clone() for n, p in pol.model.value_head.named_parameters()}
    jpath = str(tmp_path / "jax.npz")
    save_params_npz(world["params"], jpath)
    pol.load_pretrain(jpath)
    loaded = jax_flat_params(pol.model)
    for k, v in want.items():
        np.testing.assert_array_equal(loaded[k], np.asarray(v), err_msg=k)
    for n, p in pol.model.value_head.named_parameters():
        assert torch.equal(p.detach(), head[n]), n
    assert {k: v.shape for k, v in loaded.items() if "value_head" in k} == {
        "params/value_head/Dense_0/kernel": (128, 128), "params/value_head/Dense_0/bias": (128,),
        "params/value_head/LayerNorm_0/scale": (128,), "params/value_head/LayerNorm_0/bias": (128,),
        "params/value_head/Dense_1/kernel": (128, 1), "params/value_head/Dense_1/bias": (1,),
    }
