"""Fine-tune trainer over the on-device buffer (port of rift_tpu/rl/trainer.py:
`TrainConfig`, `trainable_mask`, the optimizer, one train step and the
single-device `fit`; the multi-device path comes with multi-GPU), and the
RIFT loss function of rift_tpu/runner.py:238.

Hyperparameters mirror rlft/config/rift_training.yaml: lr 1e-4, 16
epochs, 3 warmup epochs, grad clip 0.5, batch 256, closed-loop lr decay 0.9
per round, trainable layers = planning_decoder.pi_head only. The JAX
package's optax chain (clip by global norm over the trainable grads ->
Adam -> decoupled weight decay on the trainable leaves -> x(-lr)) is
`clip_grad_norm_` then `torch.optim.AdamW` over the trainable parameters;
the frozen ones are never handed to the optimizer and stay bit-identical.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

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


def train_step(model, opt, loss_fn, batch, lr: float, cfg: TrainConfig):
    """One update of the optimizer's (trainable) parameters at learning rate
    `lr`: loss, backward, clip by the global norm of their gradients,
    AdamW. Returns the loss (a 0-dim tensor, not synchronised)."""
    (group,) = opt.param_groups
    group["lr"] = lr
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(group["params"], cfg.grad_clip)
    opt.step()
    return loss.detach()


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
        round_idx: int = 0):
    """A full fine-tune round on one device: `epochs` passes of shuffled
    batches of the buffer, with a fresh optimizer state (as the
    reference's per-round engine). Updates the model's trainable
    parameters in place; the frozen ones stop requiring grad for the round.
    Returns the mean loss of each epoch."""
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
                    train_step(model, opt, loss_fn, batch, schedule(step), cfg)
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
