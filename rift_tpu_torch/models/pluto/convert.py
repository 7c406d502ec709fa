"""The pretrained Pluto checkpoint -> the port's weights (port of
rift_tpu/models/pluto/convert.py).

The reference fine-tunes from `pluto_1M_aux_cil.ckpt`
(rift/cbv/planning/pluto/pluto.py:130-137 strips the Lightning `model.`
prefix and load_state_dicts a torch PlanningModel). This converter maps that
state dict onto the JAX package's PlutoModel parameter tree, numpy only:
the same tree, key for key, as the JAX converter gives. The port's
`PlutoModel(points_norm="none")` loads it strictly through
`utils/params_io.py`'s `load_jax_params(model, flatten_params(tree))`, so a
checkpoint reaches the card without JAX.

Module correspondence (torch name -> flax path), from
rift/cbv/planning/pluto/model/pluto_model.py and submodules:

  pos_emb.*                      pos_emb/*            (FourierEmbedding)
  agent_encoder.history_encoder  AgentEncoder_0/HistoryEncoder_0
    embed.proj                     Conv_0
    levels.{j}.blocks.{i}          LocalBlock_{2j+i} (NATLayer: qkv split ->
                                     q/k/v, rpb -> rpb, proj -> out)
    levels.{j}.downsample          Conv_{j+1} (no bias) + LayerNorm_{2j+1}
    norm{j}                        LayerNorm_{2j}
    lateral_convs.{j}              Conv_{3+j}
    fpn_conv                       Conv_6
  agent_encoder.ego_state_emb    AgentEncoder_0/StateAttentionEncoder_0
  agent_encoder.type_emb         AgentEncoder_0/Embed_0
  map_encoder.polygon_encoder    MapEncoder_0/PointsEncoder_0/flat
                                   (eval-mode BatchNorm folded into the
                                    preceding Linear; build the flax model
                                    with points_norm="none")
  map_encoder.{type,on_route,traffic_light,unknown_speed}_emb + speed_limit_emb
  static_objects_encoder.*       StaticObjectsEncoder_0/*
  encoder_blocks.{i}.*           enc{i}/* (MultiheadAttention in_proj split)
  norm                           enc_norm
  agent_predictor.{loc,yaw,vel}_predictor   agent_predictor/MLPLayer_{0,1,2}
  planning_decoder.*             planning_decoder/* (decoder_blocks.{i} ->
                                   layer{i}, ffn.{0,3} -> Dense_{0,1},
                                   norm{1..4} -> LayerNorm_{0..3})
  hidden_proj.{0,2}              hidden_proj_fc{1,2}
  ref_free_decoder.*             ref_free_decoder/*

Tensor transforms: Linear W [out,in] -> kernel W.T; Conv1d [out,in,k] ->
kernel [k,in,out]; MultiheadAttention in_proj [3D,D] -> three [D,H,Dh]
kernels; out_proj [D,D] -> [H,Dh,D]; BatchNorm1d folded as
W' = diag(g/sqrt(v+eps)) W, b' = (b-mu) g/sqrt(v+eps) + beta.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...utils.params_io import flatten_params, jax_flat_params


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a torch/Lightning checkpoint into numpy, stripping the Lightning
    `model.` prefix (reference pluto.py:130-137 load semantics)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[len("model."):]
        out[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
    return out


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
def _linear_kernel(sd, key):
    return sd.pop(key + ".weight").T


def _linear_bias(sd, key):
    return sd.pop(key + ".bias")


def _conv1d(sd, key, bias: bool):
    w = sd.pop(key + ".weight").transpose(2, 1, 0)  # [k, in, out]
    b = sd.pop(key + ".bias") if bias else np.zeros(w.shape[-1], w.dtype)
    return w, b


def _fold_bn_into_linear(sd, lin_key, bn_key, eps=1e-5):
    """Eval-mode BatchNorm1d folded into the preceding Linear."""
    w = sd.pop(lin_key + ".weight")  # [out, in]
    b = sd.pop(lin_key + ".bias")
    g = sd.pop(bn_key + ".weight")
    beta = sd.pop(bn_key + ".bias")
    mu = sd.pop(bn_key + ".running_mean")
    var = sd.pop(bn_key + ".running_var")
    sd.pop(bn_key + ".num_batches_tracked", None)
    s = g / np.sqrt(var + eps)
    return (w * s[:, None]).T, (b - mu) * s + beta


def _mha(sd, key, num_heads):
    """MultiheadAttention -> dict of flax Attention params."""
    in_w = sd.pop(key + ".in_proj_weight")  # [3D, D]
    in_b = sd.pop(key + ".in_proj_bias")  # [3D]
    out_w = sd.pop(key + ".out_proj.weight")  # [D, D]
    out_b = sd.pop(key + ".out_proj.bias")
    D = out_w.shape[0]
    H, Dh = num_heads, D // num_heads

    def split(i):
        w = in_w[i * D:(i + 1) * D]  # [D, D]
        b = in_b[i * D:(i + 1) * D]
        return {"kernel": w.T.reshape(D, H, Dh), "bias": b.reshape(H, Dh)}

    return {
        "q": split(0),
        "k": split(1),
        "v": split(2),
        "out": {"kernel": out_w.T.reshape(H, Dh, D), "bias": out_b},
    }


def _packed_qkv(sd, key, num_heads, rpb=True):
    """natten NeighborhoodAttention1D -> flax Attention params (+rpb)."""
    w = sd.pop(key + ".qkv.weight")  # [3C, C]
    b = sd.pop(key + ".qkv.bias")
    pw = sd.pop(key + ".proj.weight")
    pb = sd.pop(key + ".proj.bias")
    C = pw.shape[0]
    H, Dh = num_heads, C // num_heads

    def split(i):
        return {
            "kernel": w[i * C:(i + 1) * C].T.reshape(C, H, Dh),
            "bias": b[i * C:(i + 1) * C].reshape(H, Dh),
        }

    out = {
        "q": split(0),
        "k": split(1),
        "v": split(2),
        "out": {"kernel": pw.T.reshape(H, Dh, C), "bias": pb},
    }
    if rpb:
        out["rpb"] = sd.pop(key + ".rpb")  # [H, 2k-1]
    return out


def _mlp_layer(sd, key):
    """reference MLPLayer (Linear, LayerNorm, ReLU, Linear)."""
    return {
        "Dense_0": {"kernel": _linear_kernel(sd, key + ".mlp.0"),
                    "bias": _linear_bias(sd, key + ".mlp.0")},
        "LayerNorm_0": {"scale": sd.pop(key + ".mlp.1.weight"),
                        "bias": sd.pop(key + ".mlp.1.bias")},
        "Dense_1": {"kernel": _linear_kernel(sd, key + ".mlp.3"),
                    "bias": _linear_bias(sd, key + ".mlp.3")},
    }


def _fourier(sd, key, channels):
    """Per-channel MLPs stack into [C, ...] einsum params (layers.py
    FourierEmbedding runs all channels in one kernel)."""
    out = {
        "freqs": sd.pop(key + ".freqs.weight"),
        "w1": np.stack(
            [_linear_kernel(sd, f"{key}.mlps.{i}.0") for i in range(channels)]
        ),
        "b1": np.stack(
            [_linear_bias(sd, f"{key}.mlps.{i}.0") for i in range(channels)]
        ),
        "ln_scale": np.stack(
            [sd.pop(f"{key}.mlps.{i}.1.weight") for i in range(channels)]
        ),
        "ln_bias": np.stack(
            [sd.pop(f"{key}.mlps.{i}.1.bias") for i in range(channels)]
        ),
        "w2": np.stack(
            [_linear_kernel(sd, f"{key}.mlps.{i}.3") for i in range(channels)]
        ),
        "b2": np.stack(
            [_linear_bias(sd, f"{key}.mlps.{i}.3") for i in range(channels)]
        ),
    }
    out["out_ln"] = {"scale": sd.pop(key + ".to_out.0.weight"),
                     "bias": sd.pop(key + ".to_out.0.bias")}
    out["out_fc"] = {"kernel": _linear_kernel(sd, key + ".to_out.2"),
                     "bias": _linear_bias(sd, key + ".to_out.2")}
    return out


def _layer_norm(sd, key):
    return {"scale": sd.pop(key + ".weight"), "bias": sd.pop(key + ".bias")}


def _points_encoder(sd, key):
    """PointsEncoder with BN folded -> flax `flat` subtree (norm='none')."""
    k0, b0 = _fold_bn_into_linear(sd, key + ".first_mlp.0", key + ".first_mlp.1")
    k2, b2 = _fold_bn_into_linear(sd, key + ".second_mlp.0", key + ".second_mlp.1")
    return {"flat": {
        "Dense_0": {"kernel": k0, "bias": b0},
        "Dense_1": {"kernel": _linear_kernel(sd, key + ".first_mlp.3"),
                    "bias": _linear_bias(sd, key + ".first_mlp.3")},
        "Dense_2": {"kernel": k2, "bias": b2},
        "Dense_3": {"kernel": _linear_kernel(sd, key + ".second_mlp.3"),
                    "bias": _linear_bias(sd, key + ".second_mlp.3")},
    }}


def _embed(sd, key):
    return {"embedding": sd.pop(key + ".weight")}


def _history_encoder(sd, key, depths=(2, 2, 2), heads=(2, 4, 8)):
    """NATSequenceEncoder -> the flat HistoryEncoder param dict
    (ops/history.py:weight_order): qkv packed [D, 3D], out [D, D], convs
    [k, in, out]. The flat layout lets the whole forward run as one fused
    Pallas kernel."""
    out: dict[str, Any] = {}
    w, b = _conv1d(sd, key + ".embed.proj", bias=True)
    out["conv0_w"], out["conv0_b"] = w, b
    blk = 0
    for level, (depth, h) in enumerate(zip(depths, heads)):
        for i in range(depth):
            p = f"{key}.levels.{level}.blocks.{i}"
            ln1 = _layer_norm(sd, p + ".norm1")
            out[f"blk{blk}_ln1_scale"] = ln1["scale"]
            out[f"blk{blk}_ln1_bias"] = ln1["bias"]
            qkv_w = sd.pop(p + ".attn.qkv.weight")  # [3C, C]
            qkv_b = sd.pop(p + ".attn.qkv.bias")
            out[f"blk{blk}_qkv_w"] = qkv_w.T  # [C, 3C], columns [q|k|v]
            out[f"blk{blk}_qkv_b"] = qkv_b
            out[f"blk{blk}_out_w"] = sd.pop(p + ".attn.proj.weight").T
            out[f"blk{blk}_out_b"] = sd.pop(p + ".attn.proj.bias")
            C = out[f"blk{blk}_out_w"].shape[0]
            rpb = sd.pop(p + ".attn.rpb")  # natten [H, 2w-1]
            out[f"blk{blk}_rpb"] = rpb
            ln2 = _layer_norm(sd, p + ".norm2")
            out[f"blk{blk}_ln2_scale"] = ln2["scale"]
            out[f"blk{blk}_ln2_bias"] = ln2["bias"]
            out[f"blk{blk}_mlp1_w"] = _linear_kernel(sd, p + ".mlp.fc1")
            out[f"blk{blk}_mlp1_b"] = _linear_bias(sd, p + ".mlp.fc1")
            out[f"blk{blk}_mlp2_w"] = _linear_kernel(sd, p + ".mlp.fc2")
            out[f"blk{blk}_mlp2_b"] = _linear_bias(sd, p + ".mlp.fc2")
            blk += 1
        ln = _layer_norm(sd, f"{key}.norm{level}")
        out[f"level{level}_ln_scale"] = ln["scale"]
        out[f"level{level}_ln_bias"] = ln["bias"]
        if level < len(depths) - 1:
            w, b = _conv1d(sd, f"{key}.levels.{level}.downsample.reduction",
                           bias=False)
            out[f"down{level}_w"], out[f"down{level}_b"] = w, b
            ln = _layer_norm(sd, f"{key}.levels.{level}.downsample.norm")
            out[f"down{level}_ln_scale"] = ln["scale"]
            out[f"down{level}_ln_bias"] = ln["bias"]
    for j in range(len(depths)):
        w, b = _conv1d(sd, f"{key}.lateral_convs.{j}", bias=True)
        out[f"lat{j}_w"], out[f"lat{j}_b"] = w, b
    w, b = _conv1d(sd, key + ".fpn_conv", bias=True)
    out["fpn_w"], out["fpn_b"] = w, b
    return out


def _state_attention(sd, key, state_channel=6, num_heads=4):
    out = {
        "pos_embed": sd.pop(key + ".pos_embed"),
        "query": sd.pop(key + ".query"),
        "Attention_0": _mha(sd, key + ".attn", num_heads),
    }
    out["proj_w"] = np.stack(
        [_linear_kernel(sd, f"{key}.linears.{i}") for i in range(state_channel)]
    )
    out["proj_b"] = np.stack(
        [_linear_bias(sd, f"{key}.linears.{i}") for i in range(state_channel)]
    )
    return out


def _encoder_block(sd, key, num_heads=4):
    return {
        "LayerNorm_0": _layer_norm(sd, key + ".norm1"),
        "Attention_0": _mha(sd, key + ".attn", num_heads),
        "LayerNorm_1": _layer_norm(sd, key + ".norm2"),
        "Dense_0": {"kernel": _linear_kernel(sd, key + ".mlp.fc1"),
                    "bias": _linear_bias(sd, key + ".mlp.fc1")},
        "Dense_1": {"kernel": _linear_kernel(sd, key + ".mlp.fc2"),
                    "bias": _linear_bias(sd, key + ".mlp.fc2")},
    }


def _decoder_layer(sd, key, num_heads=4):
    return {
        "LayerNorm_0": _layer_norm(sd, key + ".norm1"),
        "r2r": _mha(sd, key + ".r2r_attn", num_heads),
        "LayerNorm_1": _layer_norm(sd, key + ".norm2"),
        "m2m": _mha(sd, key + ".m2m_attn", num_heads),
        "LayerNorm_2": _layer_norm(sd, key + ".norm3"),
        "cross": _mha(sd, key + ".cross_attn", num_heads),
        "LayerNorm_3": _layer_norm(sd, key + ".norm4"),
        "Dense_0": {"kernel": _linear_kernel(sd, key + ".ffn.0"),
                    "bias": _linear_bias(sd, key + ".ffn.0")},
        "Dense_1": {"kernel": _linear_kernel(sd, key + ".ffn.3"),
                    "bias": _linear_bias(sd, key + ".ffn.3")},
    }


def convert_state_dict(
    sd: dict[str, np.ndarray],
    encoder_depth: int = 4,
    decoder_depth: int = 4,
    num_heads: int = 4,
    strict: bool = True,
) -> dict:
    """Torch PlanningModel state dict -> flax params for
    PlutoModel(points_norm="none"). Pops keys as it consumes them; with
    `strict`, leftover keys (except loss/aux buffers) raise."""
    sd = dict(sd)
    p: dict[str, Any] = {}

    p["pos_emb"] = _fourier(sd, "pos_emb", 3)
    p["AgentEncoder_0"] = {
        "HistoryEncoder_0": _history_encoder(sd, "agent_encoder.history_encoder"),
        "StateAttentionEncoder_0": _state_attention(
            sd, "agent_encoder.ego_state_emb"
        ),
        "Embed_0": _embed(sd, "agent_encoder.type_emb"),
    }
    p["MapEncoder_0"] = {
        "PointsEncoder_0": _points_encoder(sd, "map_encoder.polygon_encoder"),
        "speed_emb": _fourier(sd, "map_encoder.speed_limit_emb", 1),
        "type_emb": _embed(sd, "map_encoder.type_emb"),
        "on_route_emb": _embed(sd, "map_encoder.on_route_emb"),
        "tl_emb": _embed(sd, "map_encoder.traffic_light_emb"),
        "unknown_speed_emb": sd.pop("map_encoder.unknown_speed_emb.weight")[0],
    }
    p["StaticObjectsEncoder_0"] = {
        "FourierEmbedding_0": _fourier(sd, "static_objects_encoder.obj_encoder", 2),
        "Embed_0": _embed(sd, "static_objects_encoder.type_emb"),
    }
    for i in range(encoder_depth):
        p[f"enc{i}"] = _encoder_block(sd, f"encoder_blocks.{i}", num_heads)
    p["enc_norm"] = _layer_norm(sd, "norm")
    p["agent_predictor"] = {
        "MLPLayer_0": _mlp_layer(sd, "agent_predictor.loc_predictor"),
        "MLPLayer_1": _mlp_layer(sd, "agent_predictor.yaw_predictor"),
        "MLPLayer_2": _mlp_layer(sd, "agent_predictor.vel_predictor"),
    }
    dec: dict[str, Any] = {
        "r_pos_emb": _fourier(sd, "planning_decoder.r_pos_emb", 3),
        "r_encoder": _points_encoder(sd, "planning_decoder.r_encoder"),
        "q_proj": {"kernel": _linear_kernel(sd, "planning_decoder.q_proj"),
                   "bias": _linear_bias(sd, "planning_decoder.q_proj")},
        "m_emb": sd.pop("planning_decoder.m_emb"),
        "m_pos": sd.pop("planning_decoder.m_pos"),
        "cat_x_proj": {"kernel": _linear_kernel(sd, "planning_decoder.cat_x_proj"),
                       "bias": _linear_bias(sd, "planning_decoder.cat_x_proj")},
        "loc_head": _mlp_layer(sd, "planning_decoder.loc_head"),
        "yaw_head": _mlp_layer(sd, "planning_decoder.yaw_head"),
        "vel_head": _mlp_layer(sd, "planning_decoder.vel_head"),
        "pi_head": _mlp_layer(sd, "planning_decoder.pi_head"),
    }
    for i in range(decoder_depth):
        dec[f"layer{i}"] = _decoder_layer(
            sd, f"planning_decoder.decoder_blocks.{i}", num_heads
        )
    p["planning_decoder"] = dec
    p["hidden_proj_fc1"] = {"kernel": _linear_kernel(sd, "hidden_proj.0"),
                            "bias": _linear_bias(sd, "hidden_proj.0")}
    p["hidden_proj_fc2"] = {"kernel": _linear_kernel(sd, "hidden_proj.2"),
                            "bias": _linear_bias(sd, "hidden_proj.2")}
    p["ref_free_decoder"] = _mlp_layer(sd, "ref_free_decoder")

    leftovers = [k for k in sd if not k.startswith(("loss", "metric"))]
    if strict and leftovers:
        raise ValueError(f"unconverted torch keys: {leftovers[:10]}")

    return {"params": _tree_map(lambda x: np.asarray(x, np.float32), p)}


def load_pretrained_pluto(path: str, **kw):
    """One-call loader: checkpoint path -> (params, model_kwargs).

    The returned params require `PlutoModel(points_norm="none")`."""
    sd = load_torch_state_dict(path)
    params = convert_state_dict(sd, **kw)
    return params, {"points_norm": "none"}


def check_against_template(params: dict, template: dict) -> list[str]:
    """Compare a converted tree to a template tree (nested dicts whose
    leaves have `.shape`, e.g. `template_of(model)`); returns a list of
    mismatch descriptions (empty = structurally identical)."""
    problems = []
    t_flat = flatten_params(template)
    p_flat = flatten_params(params)
    for k in sorted(set(t_flat) | set(p_flat)):
        if k not in p_flat:
            problems.append(f"missing: {k}")
        elif k not in t_flat:
            problems.append(f"extra: {k}")
        elif tuple(np.shape(p_flat[k])) != tuple(t_flat[k].shape):
            problems.append(
                f"shape {k}: {np.shape(p_flat[k])} != {tuple(t_flat[k].shape)}"
            )
    return problems


def template_of(model) -> dict:
    """A port model's parameters as the JAX package's params tree (numpy
    leaves): the template that `check_against_template` compares with."""
    tree: dict = {}
    for key, arr in jax_flat_params(model).items():
        *path, leaf = key.split("/")
        d = tree
        for part in path:
            d = d.setdefault(part, {})
        d[leaf] = arr
    return tree

