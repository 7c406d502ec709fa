"""The port's fine-tune step against the JAX package, on the scene and
seeded weights of test_torch_train.py (`train_scene`), f32, on the CPU:
one train step, the ring buffer and a `fit` round. Apart from that file,
whose module fixture compiles the JAX train act, so that each file holds
at most three tests.

Tolerances:
- one train step: loss and the updated pi_head within 1e-5, every other
  parameter unchanged (bit-identical). The loss is invariant to a uniform
  shift of all logits, so some pi_head gradients (its output bias, the
  layer-norm bias of units active for every candidate) are float noise,
  which Adam's first step g / (|g| + 1e-8) turns into a step of up to lr
  in either direction: elements whose gradient is below 1e-6 are held to
  that bound (|step| <= lr), all others within 1e-5;
- ring_append exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.rl import buffer as jbuf
from rift_tpu.rl.losses import rift_loss as jax_rift_loss
from rift_tpu.rl.trainer import TrainConfig as JaxTrainConfig
from rift_tpu.rl.trainer import make_optimizer as jax_make_optimizer
from rift_tpu.rl.trainer import make_train_step as jax_make_train_step
from rift_tpu_torch.models.pluto import PlutoModel
from rift_tpu_torch.rl import (
    TrainConfig,
    fit,
    gather_batch,
    make_optimizer,
    rift_loss_fn,
    ring_append,
    ring_init,
    ring_reset,
    sample_batches,
    train_step,
)
from rift_tpu_torch.rl.trainer import lr_schedule
from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params
from rift_tpu_torch.utils.tensors import tree_map
from test_torch_pluto import _to_torch
from test_torch_train import DEPTH, _flat, train_scene
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """`train_scene`: the scene, both frameworks' seeded models and the
    port's train act (no JAX act step is compiled here)."""
    return train_scene(tmp_path_factory)


def test_train_step_matches_jax(scene):
    """One step from identical params and batch (the act step's samples:
    the port's act, which test_torch_train.py holds to the JAX package's)
    against make_train_step(loss, *make_optimizer(...)) at the same lr."""
    got = scene["got"]
    batch = {
        "features": _flat(got["features"]),
        "old_logits": _flat(got["old_logits"]),
        "advantage": _flat(got["advantage"]),
        "valid": _flat(got["adv_valid"]),
    }
    jbatch = tree_map(lambda x: jnp.asarray(x.numpy()), batch)
    jmodel, params = scene["jmodel"], scene["params"]

    def loss_fn(p, b, rng):
        out = jmodel.apply(p, b["features"])
        r_pad = ~b["features"]["reference_line"]["valid_mask"].any(-1)
        return jax_rift_loss(out["probability"], r_pad, b["old_logits"], b["advantage"],
                             b["valid"])

    lr = 1e-4
    tx, mask = jax_make_optimizer(params, JaxTrainConfig())
    step = jax_make_train_step(loss_fn, tx, mask)
    new_params, _, jloss = step(params, tx.init(params), jbatch, jax.random.PRNGKey(0), lr)
    new_flat = flatten_params(jax.tree.map(np.asarray, new_params))

    model = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32,
                       device="cpu")
    load_jax_params(model, scene["flat"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model, TrainConfig())
    loss = train_step(model, opt, rift_loss_fn, batch, lr, TrainConfig())
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    want = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32,
                      device="cpu")
    load_jax_params(want, new_flat)
    want = dict(want.named_parameters())
    held = 0
    for name, p in model.named_parameters():
        if not name.startswith("planning_decoder.pi_head"):
            assert torch.equal(p.detach(), before[name]), name
            continue
        # a gradient at the float-noise floor turns into Adam's first step
        # g / (|g| + 1e-8) in either framework: those elements agree only
        # in bound; every other one within 1e-5
        sig = (p.grad.abs() > 1e-6).numpy()
        got, ref = p.detach().numpy(), want[name].detach().numpy()
        np.testing.assert_allclose(got[sig], ref[sig], atol=1e-5, err_msg=name)
        step = np.abs(np.stack([got, ref]) - before[name].numpy())
        assert step.max() <= 1.01 * lr, name
        held += int(sig.sum())
        if sig.any():
            assert np.abs(got - before[name].numpy())[sig].min() > 0.5 * lr, name
    assert held > 16000  # nearly all of pi_head's 16.8k parameters


def test_ring_append_matches_jax():
    """Drop-invalid, wrap-around slots: capacity 5, appends of 3 (1
    invalid), 4 (wraps) and 2 (all invalid)."""
    r = np.random.default_rng(6)
    spec = {"x": np.zeros((2,), np.float32), "n": {"k": np.zeros((), np.int32)}}
    jb = jbuf.ring_init(jax.tree.map(jnp.asarray, spec), capacity=5)
    tb = ring_init(_to_torch(spec), capacity=5)
    for n, valid in ((3, [True, False, True]), (4, [True] * 4), (2, [False, False])):
        samples = {"x": r.normal(size=(n, 2)).astype(np.float32),
                   "n": {"k": r.integers(0, 100, n).astype(np.int32)}}
        jb = jbuf.ring_append(jb, jax.tree.map(jnp.asarray, samples), jnp.asarray(valid))
        tb = ring_append(tb, _to_torch(samples), torch.tensor(valid))
        assert (tb.size, tb.ptr) == (int(jb.size), int(jb.ptr))
        np.testing.assert_array_equal(tb.data["x"].numpy(), np.asarray(jb.data["x"]))
        np.testing.assert_array_equal(tb.data["n"]["k"].numpy(), np.asarray(jb.data["n"]["k"]))
    assert tb.full and (tb.size, tb.ptr) == (5, 1)
    gen = torch.Generator().manual_seed(0)
    idx = sample_batches(tb, gen, 2, 2)  # a permutation: 4 of the 5
    assert idx.shape == (2, 2) and len(set(idx.flatten().tolist())) == 4
    assert gather_batch(tb, idx[0])["x"].shape == (2, 2)
    assert sample_batches(tb, gen, 4, 2).max() < 5  # 8 > 5: with replacement
    assert ring_reset(tb).size == 0


def test_fit_moves_only_pi_head(scene):
    """fit over a full buffer of the act step's samples: finite losses,
    pi_head moved, everything else bit-identical; the lr follows the
    warmup-cosine schedule with the per-round decay; an empty buffer
    raises."""
    got = scene["got"]
    samples = {
        "features": _flat(got["features"]),
        "old_logits": _flat(got["old_logits"]),
        "advantage": _flat(got["advantage"]),
        "valid": _flat(got["adv_valid"]),
    }
    first = lambda t: {k: first(v) for k, v in t.items()} if isinstance(t, dict) else t[0]
    buf = ring_init(first(samples), capacity=4)
    ring_append(buf, samples, _flat(got["cbv_slots"] >= 0, lead=2).reshape(-1))
    assert buf.full
    model = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32,
                       device="cpu")
    load_jax_params(model, scene["flat"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = TrainConfig(epochs=2, warmup_epochs=1, batch_size=2)
    losses = fit(model, buf, rift_loss_fn, cfg, torch.Generator().manual_seed(0))
    assert len(losses) == 2 and np.isfinite(losses).all()
    moved = 0.0
    for n, p in model.named_parameters():
        assert p.requires_grad
        if n.startswith("planning_decoder.pi_head"):
            moved += float((p.detach() - before[n]).abs().sum())
        else:
            assert torch.equal(p.detach(), before[n]), n
    assert moved > 0.0
    sched = lr_schedule(TrainConfig(epochs=2, warmup_epochs=1), 2, round_idx=1)
    lr0 = 1e-4 * 0.9
    np.testing.assert_allclose(
        [sched(i) for i in range(4)], [0.0, lr0 / 2, lr0, (lr0 + 0.9 * lr0) / 2], rtol=1e-12
    )
    with pytest.raises(ValueError, match="empty"):
        fit(model, ring_reset(buf), rift_loss_fn, cfg, torch.Generator())
