"""Fine-tune trainer over the on-device buffer (port of rift_tpu/rl/trainer.py:
`TrainConfig`, `trainable_mask`, the optimizer, one train step and `fit`, on
one device or across the ranks of a scenario mesh), and the RIFT loss
function of rift_tpu/runner.py:238.

Hyperparameters mirror rlft/config/rift_training.yaml: lr 1e-4, 16
epochs, 3 warmup epochs, grad clip 0.5, batch 256, closed-loop lr decay 0.9
per round, trainable layers = planning_decoder.pi_head only. The JAX
package's optax chain (clip by global norm over the trainable grads ->
Adam -> decoupled weight decay on the trainable leaves -> x(-lr)) is
`clip_grad_norm_` then `torch.optim.AdamW` over the trainable parameters;
the frozen ones are never handed to the optimizer and stay bit-identical.

Across ranks (`mesh`), `fit` computes what the JAX package's SPMD fit
computes, the loss of each global batch: every rank holds the same buffer
(the Runner gathers each stored chunk) and draws the same batch indices;
it takes its block of the batch's rows and weights its loss by its share of
the count the loss divides by (a loss function's `normaliser`: for
`rift_loss_fn` the batch's valid candidates), so that the gradients summed
over the ranks are the global batch's, not a mean of per-rank means. The
clip then sees the global norm, as `optax.clip_by_global_norm`, and every
rank applies the same AdamW step: the parameters stay the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..parallel.mesh import all_reduce_sum_, shard_batch
from .buffer import RingBuffer, gather_batch, sample_batches
from .losses import rift_loss


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-4
    epochs: int = 16
    warmup_epochs: int = 3
    batch_size: int = 256
    grad_clip: float = 0.5
    cl_lr_decay: float = 0.9
    trainable_prefixes: tuple = ("planning_decoder/pi_head",)


def trainable_mask(model: torch.nn.Module, prefixes: tuple) -> dict:
    """{parameter name: trainable?}: a name is trainable when it contains
    one of the prefixes, written with "/" as the JAX package's param paths
    are ("planning_decoder/pi_head" matches "planning_decoder.pi_head.*").
    No prefixes: everything trains."""
    names = [n for n, _ in model.named_parameters()]
    if not prefixes:
        return {n: True for n in names}
    prefs = [p.replace("/", ".") for p in prefixes]
    return {n: any(p in n for p in prefs) for n in names}


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW (optax's Adam defaults: betas 0.9/0.999, eps 1e-8) over the
    trainable parameters only, with the lr set per step."""
    mask = trainable_mask(model, cfg.trainable_prefixes)
    params = [p for n, p in model.named_parameters() if mask[n]]
    return torch.optim.AdamW(
        params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay
    )


def loss_and_grads(model, loss_fn, batch, params: list, mesh=None):
    """The loss of `batch`, its gradient in the `.grad` of `params` (the
    trainable ones). With a mesh: this rank's block of the rows, its loss
    weighted by its share of `loss_fn.normaliser`, and the gradients and
    the loss summed over the ranks (one all-reduce): the whole batch's.
    Returns the loss (a 0-dim tensor)."""
    model.zero_grad(set_to_none=True)
    if mesh is None:
        loss = loss_fn(model, batch)
        loss.backward()
        return loss.detach()
    normaliser = getattr(loss_fn, "normaliser", None)
    if normaliser is None:
        raise ValueError(f"fit across ranks needs {getattr(loss_fn, '__name__', loss_fn)}"
                         ".normaliser, the count its loss divides by")
    local = shard_batch(batch, mesh)
    loss = loss_fn(model, local) * (normaliser(local) / normaliser(batch))
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().reshape(1).float()])
    all_reduce_sum_(flat, mesh)
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
        off += g.numel()
    return flat[-1]


def train_step(model, opt, loss_fn, batch, lr: float, cfg: TrainConfig, mesh=None):
    """One update of the optimizer's (trainable) parameters at learning rate
    `lr`: loss, backward (across the mesh's ranks: see `loss_and_grads`),
    clip by the global norm of their gradients, AdamW. Returns the loss (a
    0-dim tensor, not synchronised)."""
    (group,) = opt.param_groups
    group["lr"] = lr
    loss = loss_and_grads(model, loss_fn, batch, group["params"], mesh)
    torch.nn.utils.clip_grad_norm_(group["params"], cfg.grad_clip)
    opt.step()
    return loss


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int, round_idx: int = 0):
    """Host-side per-step lr: linear warmup then cosine to lr0 * decay,
    with lr0 = lr * decay**round (the closed-loop decay per round)."""
    lr0 = cfg.lr * (cfg.cl_lr_decay ** round_idx)
    min_lr = lr0 * cfg.cl_lr_decay
    total = cfg.epochs * steps_per_epoch
    warmup = max(cfg.warmup_epochs * steps_per_epoch, 1)

    def schedule(step: int) -> float:
        if step < warmup:
            return lr0 * step / warmup
        t = min((step - warmup) / max(total - warmup, 1), 1.0)
        return min_lr + 0.5 * (lr0 - min_lr) * (1.0 + math.cos(math.pi * t))

    return schedule


def fit(model, buf: RingBuffer, loss_fn, cfg: TrainConfig, gen: torch.Generator,
        round_idx: int = 0, mesh=None):
    """A full fine-tune round: `epochs` passes of shuffled batches of the
    buffer, with a fresh optimizer state (as the reference's per-round
    engine). Updates the model's trainable parameters in place; the frozen
    ones stop requiring grad for the round. With a `mesh`, each batch is
    split over its ranks (the module docstring says how); every rank must
    pass the same buffer and an equally seeded `gen`. Returns the mean loss
    of each epoch."""
    size = int(buf.size)
    if size == 0:
        raise ValueError(
            "fit() called with an empty rollout buffer: the episode produced "
            "no valid CBV samples"
        )
    steps_per_epoch = max(size // cfg.batch_size, 1)
    schedule = lr_schedule(cfg, steps_per_epoch, round_idx)
    opt = make_optimizer(model, cfg)
    trainable = {id(p) for p in opt.param_groups[0]["params"]}
    frozen = [p for p in model.parameters() if id(p) not in trainable and p.requires_grad]
    for p in frozen:
        p.requires_grad_(False)
    try:
        epoch_losses, step = [], 0
        for _ in range(cfg.epochs):
            idx = sample_batches(buf, gen, cfg.batch_size, steps_per_epoch)
            losses = []
            for b in range(steps_per_epoch):
                batch = gather_batch(buf, idx[b])
                losses.append(
                    train_step(model, opt, loss_fn, batch, schedule(step), cfg, mesh)
                )
                step += 1
            epoch_losses.append(float(torch.stack(losses).mean()))
    finally:
        for p in frozen:
            p.requires_grad_(True)
    return epoch_losses


def rift_loss_fn(model, batch):
    """The RIFT loss of a buffered batch (rift_tpu/runner.py:238
    `_rift_loss_fn`): the model's forward on the per-sample features, the
    auxiliary agent-prediction head skipped (no loss reads it)."""
    out = model({**batch["features"], "no_aux": True})
    r_pad = ~batch["features"]["reference_line"]["valid_mask"].any(-1)
    return rift_loss(
        out["probability"], r_pad, batch["old_logits"], batch["advantage"], batch["valid"]
    )


# the count rift_loss divides by: the batch's valid candidates (at least 1)
rift_loss_fn.normaliser = lambda batch: torch.clamp(batch["valid"].sum(), min=1)
