"""Behaviour-cloning fit of the E2E camera stacks (port of
rift_tpu/models/e2e/train.py).

The reference trains UniAD / VAD / SparseDrive offline on logged sensor
data and runs them frozen in closed loop. Here, as for PlanT: roll the
privileged PDM expert closed-loop, render the semantic cameras at every
tick, and clone the realised future ego motion, with a detection auxiliary
supervised by the privileged agent boxes.

    from rift_tpu_torch.models.e2e import bc_train
    model, losses = bc_train("vad", tmap, spec, state, crit, ...)

The dataset stays on the device: a sample's cameras are 6 x 24 x 48 x 8
float32 (221 KB), so the CLI's 120 ticks at S=64 hold about 1.4 GB.
The optimiser is optax's `chain(clip_by_global_norm(0.5), adamw(lr))`:
the gradients scaled by 0.5 / norm where their global norm reaches 0.5,
then AdamW with weight decay 1e-4 on every parameter.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...sim.state import CLASS_VEHICLE
from ..plant.train import ADAMW
from .model import BEV_H, BEV_W, BEV_X0, BEV_X1, BEV_Y0, BEV_Y1, PRED_LEN, E2EModel
from .model import init_e2e_weights
from .policy import e2e_inputs

WP_TICK_STRIDE = 5  # 0.5 s between label waypoints at 10 fps
CLIP_NORM = 0.5


def bc_rollout(tmap, spec, state, crit, ticks: int):
    """Roll the PDM expert `ticks` steps from `state`; returns the list of
    the states after each step. The states' tick is read once, at the start."""
    from ...ego.pdm_ego import pdm_ego_waypoints
    from ...scenario.env import env_step

    tick = int(state.tick[0])
    states = []
    for k in range(ticks):
        traj = pdm_ego_waypoints(spec, state, tmap)
        state, crit = env_step(tmap, spec, state, crit, ego_traj=traj, tick=tick + k)
        states.append(state)
    return states


def _to_ego_frame(points, origin, heading):
    rel = points - origin
    c, s = torch.cos(-heading), torch.sin(-heading)
    return torch.stack([rel[..., 0] * c - rel[..., 1] * s, rel[..., 0] * s + rel[..., 1] * c], -1)


def bc_dataset(tmap, spec, states, stride: int = WP_TICK_STRIDE) -> dict:
    """states (length T) -> dict of tensors on the states' device, flattened
    over [T', S]: imgs, target, speed, wp [PRED_LEN, 2], and the detection
    targets det_boxes [A, 5] / det_mask [A] in the ego frame."""
    horizon = PRED_LEN * stride
    cols = {k: [] for k in ("imgs", "target", "speed", "wp", "det_boxes", "det_mask")}
    for t in range(0, len(states) - horizon):
        st = states[t]
        imgs, target, speed = e2e_inputs(spec, st, tmap)
        ego_pos, ego_heading = st.pos[:, 0], st.heading[:, 0]
        future = torch.stack([states[t + stride * (k + 1)].pos[:, 0] for k in range(PRED_LEN)],
                             1)  # [S, PRED_LEN, 2]
        # privileged detection targets: alive non-ego vehicles in BEV range
        A = st.alive.shape[1]
        centers = _to_ego_frame(st.pos, ego_pos[:, None], ego_heading[:, None])
        yaw_rel = st.heading - ego_heading[:, None]
        in_bev = ((centers[..., 0] > BEV_X0) & (centers[..., 0] < BEV_X1)
                  & (centers[..., 1] > BEV_Y0) & (centers[..., 1] < BEV_Y1))
        for k, v in (
            ("imgs", imgs), ("target", target), ("speed", speed),
            ("wp", _to_ego_frame(future, ego_pos[:, None], ego_heading[:, None])),
            # (cx, cy, w, l, yaw): the shape is (width, length)
            ("det_boxes", torch.cat([centers, st.shape, yaw_rel[..., None]], -1)),
            ("det_mask", st.alive & in_bev & (torch.arange(A, device=st.pos.device) != 0)
             & (st.agent_class == CLASS_VEHICLE)),
        ):
            cols[k].append(v)
    return {k: torch.cat(v) for k, v in cols.items()}


def _sigmoid_bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _softmax_ce(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels."""
    logits = logits - logits.amax(-1, keepdim=True).detach()
    label_logits = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.log(torch.exp(logits).sum(-1)) - label_logits


def _assigned_det_loss(pred_boxes, pred_score, gt_boxes, gt_mask, assign):
    """Each truth supervises the prediction `assign` [B, A] picked for it;
    predictions without a truth are scored toward 0."""
    occ = torch.zeros_like(pred_score).scatter_reduce(1, assign, gt_mask.float(), "amax",
                                                       include_self=True)
    score_loss = _sigmoid_bce(pred_score, occ).mean()
    matched = torch.gather(pred_boxes, 1, assign[..., None].expand(-1, -1, 5))
    reg = torch.abs(matched[..., :4] - gt_boxes[..., :4]).sum(-1)
    ang = 1.0 - torch.cos(matched[..., 4] - gt_boxes[..., 4])
    reg_loss = torch.where(gt_mask, reg + ang, 0.0).sum() / torch.clamp(gt_mask.sum(), min=1)
    return score_loss + 0.2 * reg_loss


def _dense_det_loss(pred_boxes, pred_score, gt_boxes, gt_mask):
    """Cell-assignment detection loss of the BEV heads: each truth
    supervises the cell holding its centre; empty cells score toward 0."""
    cell_x = (BEV_X1 - BEV_X0) / BEV_W
    cell_y = (BEV_Y1 - BEV_Y0) / BEV_H
    ix = torch.clamp(((gt_boxes[..., 0] - BEV_X0) / cell_x).to(torch.int32), 0, BEV_W - 1)
    iy = torch.clamp(((gt_boxes[..., 1] - BEV_Y0) / cell_y).to(torch.int32), 0, BEV_H - 1)
    return _assigned_det_loss(pred_boxes, pred_score, gt_boxes, gt_mask,
                              (iy * BEV_W + ix).long())


def _sparse_det_loss(pred_boxes, pred_score, gt_boxes, gt_mask):
    """Nearest-anchor assignment (no gradient through it) of the sparse head."""
    d = torch.linalg.norm(pred_boxes[:, :, None, :2].detach() - gt_boxes[:, None, :, :2], dim=-1)
    d = torch.where(gt_mask[:, None, :], d, torch.inf)  # [B, Q, A]
    return _assigned_det_loss(pred_boxes, pred_score, gt_boxes, gt_mask, torch.argmin(d, 1))


def bc_loss(model: E2EModel, batch: dict) -> torch.Tensor:
    """L1 on the waypoints (VAD: also on the soft blend, and the
    vocabulary's cross-entropy toward the mode nearest the label) plus half
    the detection loss."""
    out = model(batch["imgs"], batch["target"], batch["speed"])
    wp = batch["wp"]
    loss = torch.abs(out["pred_wp"] - wp).mean()
    if "pred_wp_soft" in out:
        loss = loss + torch.abs(out["pred_wp_soft"] - wp).mean()
        d = torch.abs(model.traj_modes.detach()[None] - wp[:, None]).sum((-1, -2))  # [B, K]
        loss = loss + 0.2 * _softmax_ce(out["mode_logits"], torch.argmin(d, -1)).mean()
    det = _sparse_det_loss if model.variant == "sparsedrive" else _dense_det_loss
    return loss + 0.5 * det(out["det_boxes"], out["det_scores"], batch["det_boxes"],
                            batch["det_mask"])


def bc_step(model: E2EModel, opt, batch: dict) -> torch.Tensor:
    """One step: the loss, its gradients clipped to global norm 0.5 as
    optax clips them ((g / norm) * 0.5 where norm >= 0.5), AdamW. Returns
    the loss (not synchronised)."""
    loss = bc_loss(model, batch)
    opt.zero_grad(set_to_none=False)
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < CLIP_NORM, g, g / norm * CLIP_NORM))
    opt.step()
    return loss.detach()


def bc_fit(model: E2EModel, data: dict, epochs: int = 4, batch_size: int = 16,
           lr: float = 3e-4, seed: int = 0) -> list:
    """Fit `model` in place on `data` (bc_dataset's dict): each epoch visits
    `np.random.default_rng(seed).permutation(N)` in batches of
    `batch_size`, the remainder dropped, as the JAX fit draws them. Returns
    every step's loss."""
    n = data["imgs"].shape[0]
    dev = data["imgs"].device
    for p in model.parameters():  # optax decays every leaf, with or without a gradient
        p.grad = torch.zeros_like(p)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, **ADAMW)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.from_numpy(order[i:i + batch_size]).to(dev)
            losses.append(float(bc_step(model, opt, {k: v[idx] for k, v in data.items()})))
    return losses


def bc_train(variant: str, tmap, spec, state, crit, ticks: int = 120, epochs: int = 4,
             batch_size: int = 16, lr: float = 3e-4, seed: int = 0):
    """Closed-loop behaviour-cloning bootstrap: the PDM expert's rollout,
    its dataset, and a fit of a fresh `E2EModel(variant)` at the default
    width, its weights from a CPU generator seeded `seed` (the JAX package
    inits it from `PRNGKey(seed)`). Returns (model, loss history)."""
    states = bc_rollout(tmap, spec, state, crit, ticks)
    data = bc_dataset(tmap, spec, states)
    model = init_e2e_weights(E2EModel(variant=variant), torch.Generator().manual_seed(seed))
    model = model.to(state.pos.device).train()
    return model, bc_fit(model, data, epochs, batch_size, lr, seed)
