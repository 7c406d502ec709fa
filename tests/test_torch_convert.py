"""The port's Pluto checkpoint converter (rift_tpu_torch/models/pluto/
convert.py) against the JAX package's, on tests/test_convert.py's
fabricated reference state dict (the reference PlanningModel's key names
and shapes): the converted trees equal key for key and bit for bit, both
reject leftover keys, both read a Lightning checkpoint file alike, and the
tree loads strictly into the port's `PlutoModel(points_norm="none")`,
whose forward is finite. chip_smoke.py fabricates its state dict without
the tests; it must have the same keys and shapes.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rift_tpu.models.pluto.convert import convert_state_dict as jax_convert
from rift_tpu.models.pluto.convert import load_torch_state_dict as jax_load_sd
from rift_tpu_torch.models.pluto import PlutoModel
from rift_tpu_torch.models.pluto.convert import (
    check_against_template,
    convert_state_dict,
    load_pretrained_pluto,
    load_torch_state_dict,
    template_of,
)
from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params
from test_convert import _fake_features, fake_reference_state_dict
from torch_parity import one_torch_thread


def _lightning_file(path, sd):
    """`sd` as a Lightning checkpoint: {"state_dict": {"model." + key: tensor}}
    beside the trainer's other entries."""
    torch.save({"epoch": 3, "state_dict": {f"model.{k}": torch.from_numpy(np.asarray(v))
                                           for k, v in sd.items()}}, path)
    return path


def test_converted_tree_equals_jax(tmp_path):
    """Key for key, bit for bit and in the same dtypes, from the dict and
    from a Lightning file read by each package's loader; leftover keys
    raise in both."""
    sd = fake_reference_state_dict()
    ref = flatten_params(jax.tree.map(np.asarray, jax_convert(sd)))
    got = flatten_params(convert_state_dict(sd))
    assert sorted(got) == sorted(ref) and len(got) == 448
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    path = _lightning_file(str(tmp_path / "pluto.ckpt"), sd)
    jsd, tsd = jax_load_sd(path), load_torch_state_dict(path)
    assert sorted(tsd) == sorted(jsd) == sorted(sd)
    for k in sd:
        assert tsd[k].dtype == jsd[k].dtype, k
        np.testing.assert_array_equal(tsd[k], jsd[k], err_msg=k)
        np.testing.assert_array_equal(tsd[k], sd[k], err_msg=k)
    params, kw = load_pretrained_pluto(path)
    assert kw == {"points_norm": "none"}
    for k, v in flatten_params(params).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)

    sd["unexpected.key"] = np.zeros(3, np.float32)
    for convert in (jax_convert, convert_state_dict):
        with pytest.raises(ValueError, match="unconverted"):
            convert(sd)


def test_strict_load_and_forward():
    """The converted tree has the port model's structure
    (`check_against_template`, and a missing and a reshaped leaf are
    named), loads strictly, and the model's forward on a legacy feature
    batch is finite; the map's PointNet runs without its layer norms."""
    params = convert_state_dict(fake_reference_state_dict())
    model = PlutoModel(points_norm="none", dtype=torch.float32, device="cpu").eval()
    assert check_against_template(params, template_of(model)) == []
    flat = flatten_params(params)
    load_jax_params(model, flat)
    assert not model.MapEncoder_0.PointsEncoder_0.has_ln
    for name, p in model.named_parameters():  # every value came from the tree
        assert torch.isfinite(p).all(), name
    broken = {"params": {k: v for k, v in params["params"].items() if k != "enc_norm"}}
    broken["params"]["hidden_proj_fc1"] = {"kernel": np.zeros((3, 3), np.float32),
                                           "bias": np.zeros(128, np.float32)}
    problems = check_against_template(broken, template_of(model))
    assert "missing: params/enc_norm/scale" in problems
    assert any(p.startswith("shape params/hidden_proj_fc1/kernel") for p in problems)

    feats = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), _fake_features())
    feats = {g: {k: v.long() if not v.is_floating_point() and v.dtype != torch.bool else v
                 for k, v in d.items()} if isinstance(d, dict) else d
             for g, d in feats.items()}
    with torch.no_grad():
        out = model(feats)
    assert out["trajectory"].shape == (2, 4, 12, 80, 6)
    assert torch.isfinite(out["trajectory"]).all() and torch.isfinite(out["probability"]).all()


def test_chip_smoke_state_dict_matches_test():
    """chip_smoke.py's numpy-only state dict: the test's keys and shapes
    (its values are seeded by key, the test's by Python's string hash)."""
    want = fake_reference_state_dict()
    got = chip_smoke.fake_pluto_state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    again = chip_smoke.fake_pluto_state_dict()
    assert all(np.array_equal(again[k], got[k]) for k in got)  # one set of values
    flatten_params(convert_state_dict(got))  # converts without leftovers
