"""The port's E2E camera stacks (models/e2e/model.py) against the JAX
package's, on the CPU, one case per variant.

The JAX model's params come from `init` under a PRNG key, are saved with
the JAX package's `save_params_npz` and loaded strictly into the port's
model (`load_jax_params`, no table of renames); the port's flat params
(`jax_flat_params`) are the npz's keys and values. The inputs are the
port's cameras, target points and speeds of six scenes (a grid town at
S=2, A=8, after 0, 4 and 8 ticks of the port's env), and random
behaviour-cloning labels for `bc_loss`. The JAX side is one jitted
program per variant: init with its outputs, and `bc_loss` on them.

Tolerances: `pred_wp`, `det_boxes`, `det_scores` (and VAD's
`pred_wp_soft` and `mode_logits`) within 1e-4 (atol and rtol; f32 sums
in another order through two deformable layers and the GRU); VAD's chosen
mode and SparseDrive's 3D-NMS keep mask exactly; the loss within 1e-5
relative.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ego import sensors as jsensors
from rift_tpu.models.e2e import E2EModel as JaxE2E
from rift_tpu.models.e2e.train import bc_loss as jax_bc_loss
from rift_tpu.utils.params_io import save_params_npz as jax_save_params
from rift_tpu_torch.map import make_grid_town
from rift_tpu_torch.models.e2e import E2EModel, e2e_inputs
from rift_tpu_torch.models.e2e.train import bc_loss
from rift_tpu_torch.scenario import TrafficEnv
from rift_tpu_torch.utils.params_io import flatten_params, jax_flat_params, load_jax_params
from rift_tpu_torch.utils.params_io import load_params_npz
from torch_parity import one_torch_thread

TOL = dict(atol=1e-4, rtol=1e-4)
VARIANTS = ("uniad", "vad", "sparsedrive")


@pytest.fixture(scope="module")
def batch():
    """Six scenes' model inputs (numpy) and random BC labels: waypoints and
    detection targets in BEV range, a third of them masked."""
    tm = make_grid_town(device="cpu")
    env = TrafficEnv(tm, num_scenarios=2, num_agents=8, seed=3, num_walkers=1,
                     num_statics=1, device="cpu")
    state, crit, spec = env.reset()
    cols = []
    for ticks in (0, 4, 4):
        for _ in range(ticks):
            state, crit = env.step(state, crit)
        cols.append([x.numpy() for x in e2e_inputs(spec, state, tm)])
    imgs, target, speed = (np.concatenate(c) for c in zip(*cols))
    r = np.random.default_rng(0)
    n, A = imgs.shape[0], 8
    boxes = np.concatenate([r.uniform(-6, 54, (n, A, 1)), r.uniform(-30, 30, (n, A, 1)),
                            r.uniform(1.5, 2.5, (n, A, 1)), r.uniform(3.5, 5.5, (n, A, 1)),
                            r.uniform(-0.5, 0.5, (n, A, 1))], -1).astype(np.float32)
    return {"imgs": imgs, "target": target, "speed": speed,
            "wp": np.cumsum(r.uniform(0, 4, (n, 4, 2)), 1).astype(np.float32),
            "det_boxes": boxes, "det_mask": r.random((n, A)) < 0.67}


@pytest.fixture(scope="module")
def jax_models(batch):
    """Per variant: (params, outputs, loss) of the JAX model, from one jitted
    program each."""
    jsensors._rays()  # the module's ray cache, made outside any trace
    out = {}
    for v in VARIANTS:
        m = JaxE2E(variant=v)

        def run(key, b, m=m):
            out, params = m.init_with_output(key, b["imgs"], b["target"], b["speed"])
            # the JAX loss on these outputs: its model's `apply` hands them back
            applied = types.SimpleNamespace(variant=m.variant, apply=lambda *a: out)
            return params, out, jax_bc_loss(applied, params, b)

        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        out[v] = jax.jit(run)(jax.random.PRNGKey(7), jb)
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_e2e_model_matches_jax(tmp_path, batch, jax_models, variant):
    params, ref, ref_loss = jax_models[variant]
    path = str(tmp_path / f"{variant}.npz")
    jax_save_params(params, path)
    model = E2EModel(variant)
    load_jax_params(model, flatten_params(load_params_npz(path)))
    with np.load(path) as saved:
        flat = jax_flat_params(model)
        assert sorted(flat) == sorted(saved.files)
        for key in saved.files:
            np.testing.assert_array_equal(flat[key], saved[key], err_msg=key)

    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    with torch.no_grad():
        got = model(tb["imgs"], tb["target"], tb["speed"])
        loss = bc_loss(model, tb)
    assert sorted(got) == sorted(ref)
    for key in ("pred_wp", "det_boxes", "det_scores", "pred_wp_soft", "mode_logits"):
        if key in ref:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), err_msg=key,
                                       **TOL)
    if variant == "vad":
        np.testing.assert_array_equal(got["mode_logits"].argmax(-1).numpy(),
                                      np.asarray(ref["mode_logits"]).argmax(-1))
    if variant == "sparsedrive":
        keep = got["det_keep"].numpy()
        np.testing.assert_array_equal(keep, np.asarray(ref["det_keep"]))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
