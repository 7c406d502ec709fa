"""The port's Pluto on legacy per-CBV tokens against the JAX package's,
on the CPU: the model's forward and one fit step's loss and gradients on
the train act's buffered samples, on the scene and seeded weights of
test_torch_legacy.py (`legacy_scene`), f32 unless stated. Apart from
that file, whose module fixture compiles the two JAX act steps, so that
each file holds at most three tests.

Tolerances:
- the forward 1e-3 (atol and rtol, through ~30 chained layers, as the
  canonical forward's test); in bf16 8e-2 (the canonical bf16 test's
  bound; observed 0.03);
- the fit step: the RIFT loss 1e-5; the gradient of every parameter
  within 1e-6 + 1e-4 of its largest element (atol; products summed in
  another order through the whole model: observed 8.7e-7 on gradients of
  up to 0.09).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.models.pluto import PlutoModel as JaxPluto
from rift_tpu.rl.losses import rift_loss as jax_rift_loss
from rift_tpu_torch.models.pluto import pluto_cbv_act
from rift_tpu_torch.rl import TrainConfig, fit, rift_loss_fn, ring_append, ring_init
from rift_tpu_torch.utils.params_io import flatten_params
from rift_tpu_torch.utils.tensors import tree_map
from test_torch_legacy import C, DEPTH, _model, legacy_scene
from test_torch_pluto import _to_torch
from test_torch_train import _flat
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """`legacy_scene` and the port's train act on it (no JAX act step is
    compiled here)."""
    w = legacy_scene(tmp_path_factory)
    got_train = pluto_cbv_act(w["model"], w["tmap"], w["spec"], w["state"], max_cbvs=C,
                              train=True)
    return dict(w, got_train=got_train)


def test_legacy_forward_matches(scene):
    """The full forward on the legacy batch, aux head included, f32; then
    bf16, whose legacy map tokens come out in f32 as the JAX package's (the
    unknown-speed embedding is an f32 parameter)."""
    ref = jax.jit(scene["jmodel"].apply)(scene["params"], scene["batch"])
    with torch.no_grad():
        got = scene["model"](_to_torch(scene["batch"]))
    for k in ("probability", "trajectory", "output_ref_free_trajectory", "hidden",
              "output_prediction", "output_trajectory"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-3, rtol=1e-3,
                                   err_msg=k)
    ref16 = jax.jit(JaxPluto(encoder_depth=DEPTH, decoder_depth=DEPTH).apply)(
        scene["params"], scene["batch"])
    with torch.no_grad():
        got16 = _model(scene["flat"], torch.bfloat16)(_to_torch(scene["batch"]))
    for k in ("probability", "trajectory", "hidden"):
        np.testing.assert_allclose(got16[k].numpy(), np.asarray(ref16[k]), atol=8e-2,
                                   err_msg=k)


def test_legacy_fit_step_matches(scene):
    """The RIFT loss of a batch of the train act's legacy samples (the
    port's act, which test_torch_legacy.py holds to the JAX package's) and
    its gradient w.r.t. every parameter against jax.value_and_grad on the
    same batch; then a `fit` round on a full buffer of them moves pi_head
    and nothing else."""
    got = scene["got_train"]
    samples = {"features": _flat(got["features"]), "old_logits": _flat(got["old_logits"]),
               "advantage": _flat(got["advantage"]), "valid": _flat(got["adv_valid"])}
    jbatch = tree_map(lambda x: jnp.asarray(x.numpy()), samples)
    jmodel = scene["jmodel"]

    def loss_fn(p):
        out = jmodel.apply(p, jbatch["features"])
        r_pad = ~jbatch["features"]["reference_line"]["valid_mask"].any(-1)
        return jax_rift_loss(out["probability"], r_pad, jbatch["old_logits"],
                             jbatch["advantage"], jbatch["valid"])

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(scene["params"])
    want = _model(flatten_params(jax.tree.map(np.asarray, jgrad)))
    model = _model(scene["flat"])
    loss = rift_loss_fn(model, samples)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5)
    want = dict(want.named_parameters())
    for name, p in model.named_parameters():
        w = want[name].detach().numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, atol=1e-6 + 1e-4 * np.abs(w).max(), err_msg=name)
    assert np.abs(want["planning_decoder.pi_head.Dense_1.weight"].detach().numpy()).max() > 0

    first = lambda t: {k: first(v) for k, v in t.items()} if isinstance(t, dict) else t[0]
    buf = ring_init(first(samples), capacity=4)
    ring_append(buf, samples, _flat(got["cbv_slots"] >= 0).reshape(-1))
    assert buf.full
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = fit(model, buf, rift_loss_fn, TrainConfig(epochs=2, warmup_epochs=1, batch_size=2),
                 torch.Generator().manual_seed(0))
    assert np.isfinite(losses).all()
    moved = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])]
    assert moved and all(n.startswith("planning_decoder.pi_head") for n in moved)
