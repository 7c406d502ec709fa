"""The port's PlanT model (models/plant) against the JAX package's, on the
CPU, and the port as a whole: every module of rift_tpu_torch imports with
jax, flax and rift_tpu blocked.

The JAX model's params are initialised from a PRNG key, saved with the
JAX package's `save_params_npz` and loaded strictly into the port's model
(test_torch_plant.py's `model_pair`). Checked: `PlanTModel`'s outputs
(waypoints, attention scores, CLS vector, forecast logits) at a small
width (dim 64, 2 heads: head dim 32) and at head dim 64 (dim 128, 2
heads), the port's flat parameters equal to the npz's keys and values.

Tolerances: the model's outputs 1e-5 (atol and rtol; f32 products summed
in another order; the GRU's four steps).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_plant import TOL, model_pair
from torch_parity import one_torch_thread

# (dim, num_layers, num_heads, forecast_heads): head dim 32 and 64
WIDTHS = {"dh32": (64, 2, 2, True), "dh64": (128, 2, 2, False)}


def random_tokens(seed, B, O):
    r = np.random.default_rng(seed)
    tokens = r.normal(0, 3, (B, O, 7)).astype(np.float32)
    tokens[..., 0] = r.choice([0.0, 1.0, 2.0], size=(B, O), p=[0.3, 0.5, 0.2])
    tokens[0, 5:, 0] = 0.0  # a row mostly padding
    target = r.normal(0, 20, (B, 2)).astype(np.float32)
    light = (r.random((B, 1)) < 0.5).astype(np.float32)
    return tokens, target, light


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_plant_model_matches_jax(tmp_path, width):
    dim, layers, heads, forecast = WIDTHS[width]
    jm, params, tm = model_pair(tmp_path, dim, layers, heads, forecast)
    tokens, target, light = random_tokens(1, 4, 18)
    ref = jax.jit(jm.apply)(params, jnp.asarray(tokens), jnp.asarray(target),
                            jnp.asarray(light))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), torch.from_numpy(target), torch.from_numpy(light))
    keys = ("pred_wp", "attn_scores", "cls") + (("forecast_logits",) if forecast else ())
    assert sorted(got) == sorted(ref) == sorted(keys)
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), err_msg=key, **TOL)
    assert (got["attn_scores"].numpy()[tokens[..., 0] == 0] == -1e9).all()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of rift_tpu_torch, imported in a fresh interpreter in
    which importing jax, jaxlib, flax or rift_tpu raises."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'rift_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import rift_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(rift_tpu_torch.__path__, "
        "'rift_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "print(len(mods))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 60  # the package's modules, PlanT's and the maps'
