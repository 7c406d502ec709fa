"""E2E camera AV stacks: compact UniAD / VAD / SparseDrive (port of
rift_tpu/models/e2e/model.py).

The same architecture shapes as the reference's stacks (multi-camera
features -> deformable perception -> query-based planning), each variant
built around the op its namesake is built around:

  uniad       query chain: BEV (ms_deform_attn spatial cross-attention,
              BEVFormer-style) -> detection queries -> track and motion
              queries -> ego plan query -> GRU waypoints
  vad         vectorized planning: BEV -> ego query -> scored trajectory
              vocabulary, a collision prior pooled under each candidate's
              end pose by roi_align_rotated; argmax (eval) and a softmax
              blend (train)
  sparsedrive BEV-free sparse instance anchors refined by
              deformable_aggregation over the camera pyramid; 3D-NMS
              detections; furthest-point-sampled instances feed the plan
              query

All three share the conv backbone and return `pred_wp [B, T, 2]` ego-frame
waypoints for env_step's `ego_traj` (as PlanT), plus detection outputs for
the behaviour-cloning auxiliary loss.

Submodules and parameters carry the flax names (`backbone.conv1`,
`sca_0.sampling_offsets`, `self_0.MultiHeadDotProductAttention_0.query`,
`wp.cell.ir`, `bev_query`, `traj_modes`, `anchors`, ...), so that
`utils.params_io.load_jax_params` loads a JAX npz strictly. Where flax and
torch differ the port follows flax: stride-2 convolutions pad "SAME" (0
before, 1 after), features flatten channels last, layer norms take
epsilon 1e-6, and the median is the mean of the two middle values.
Everything computes in f32. No hand kernel runs here: the JAX model
reaches no Pallas kernel (its attention is flax's, its ops XLA
composites).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ego.sensors import (
    IMG_H,
    IMG_W,
    NUM_CAMERAS,
    NUM_CHANNELS,
    pixel_ground_table,
    project_points,
)
from ...ops.e2e import (
    deformable_aggregation,
    dynamic_scatter_mean,
    furthest_point_sample,
    knn,
    ms_deform_attn,
    nms3d,
    nms_rotated,
    roi_align_rotated,
    voxelize,
)
from ..plant.model import GRUCell
from ..pluto.layers import Dense, LayerNorm

PRED_LEN = 4  # waypoints, 0.5 s apart (the PlanT convention)

# BEV grid: forward-biased ego-frame lattice
BEV_H, BEV_W = 16, 16
BEV_X0, BEV_X1 = -8.0, 56.0  # longitudinal extent (m)
BEV_Y0, BEV_Y1 = -32.0, 32.0  # lateral extent (m)

NUM_LEVELS = 2  # feature pyramid scales per camera
NUM_POINTS = 4  # deformable sampling points per level
LN_EPS = 1e-6  # flax nn.LayerNorm's default
VARIANTS = ("uniad", "vad", "sparsedrive")


def bev_cell_centers() -> np.ndarray:
    """[BEV_H * BEV_W, 2] ego-frame (x fwd, y left) cell centers."""
    xs = np.linspace(BEV_X0, BEV_X1, BEV_W, endpoint=False) + (BEV_X1 - BEV_X0) / BEV_W / 2
    ys = np.linspace(BEV_Y0, BEV_Y1, BEV_H, endpoint=False) + (BEV_Y1 - BEV_Y0) / BEV_H / 2
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32)


def _ln(dim):
    return LayerNorm(dim, eps=LN_EPS)


class Conv(nn.Conv2d):
    """flax nn.Conv 3x3 with "SAME" padding on NHWC input: stride 1 pads 1
    on each side, stride 2 (on even sizes) 0 before and 1 after, where
    nn.Conv2d(padding=1) would pad 1 before and shift every output."""

    def __init__(self, in_ch, out_ch, stride=1):
        super().__init__(in_ch, out_ch, 3, stride=stride, padding=0)

    def forward(self, x):  # [N, H, W, C] -> [N, H', W', C']
        pad = (1, 1, 1, 1) if self.stride[0] == 1 else (0, 1, 0, 1)
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pad), self.weight, self.bias, self.stride)
        return y.permute(0, 2, 3, 1)


class CameraBackbone(nn.Module):
    """Shared conv pyramid: [B, N_CAM, H, W, C] -> per-camera feature levels
    (H/2, W/2) and (H/4, W/4), flattened for the deformable ops: value
    [B, num_keys, dim] (for each camera, each level's h*w rows in row-major
    order, channels last) and their shapes [[(h, w) per level] per camera]."""

    def __init__(self, dim=64, num_heads=4):
        super().__init__()
        self.dim = dim
        self.conv1 = Conv(NUM_CHANNELS, 32, stride=2)
        self.ln1 = _ln(32)
        self.proj1 = Conv(32, dim)
        self.conv2 = Conv(32, dim, stride=2)
        self.ln2 = _ln(dim)
        self.proj2 = Conv(dim, dim)

    def forward(self, imgs):
        B = imgs.shape[0]
        x = imgs.reshape(B * NUM_CAMERAS, IMG_H, IMG_W, NUM_CHANNELS)
        x = torch.relu(self.ln1(self.conv1(x)))
        l1 = self.proj1(x)
        x = torch.relu(self.ln2(self.conv2(x)))
        l2 = self.proj2(x)
        levels = [lvl.reshape(B, NUM_CAMERAS, -1, self.dim) for lvl in (l1, l2)]
        shapes = [[tuple(lvl.shape[1:3]) for lvl in (l1, l2)]] * NUM_CAMERAS
        value = torch.cat([lvl[:, cam] for cam in range(NUM_CAMERAS) for lvl in levels], 1)
        return value, shapes


class BEVCrossAttention(nn.Module):
    """BEVFormer-style spatial cross-attention: each BEV query deform-samples
    the camera pyramid around its (static) projected anchor via
    ops.e2e.ms_deform_attn."""

    def __init__(self, dim=64, num_heads=4):
        super().__init__()
        self.num_heads = num_heads
        L = NUM_CAMERAS * NUM_LEVELS
        self.sampling_offsets = Dense(dim, num_heads * L * NUM_POINTS * 2)
        self.attention_weights = Dense(dim, num_heads * L * NUM_POINTS)
        self.out_proj = Dense(dim, dim)

    def forward(self, queries, value, shapes, base_uv, in_view):
        # queries [B, Q, D]; base_uv [Q, N_CAM, 2]; in_view [Q, N_CAM]
        B, Q, D = queries.shape
        L = NUM_CAMERAS * NUM_LEVELS
        H, P = self.num_heads, NUM_POINTS
        off = self.sampling_offsets(queries).reshape(B, Q, H, L, P, 2)
        attn = self.attention_weights(queries).reshape(B, Q, H, L, P)
        # anchor each (cam, level) at the camera projection; out-of-view
        # cameras are hidden from the softmax
        base = torch.repeat_interleave(base_uv, NUM_LEVELS, dim=1)  # [Q, L, 2]
        vis = torch.repeat_interleave(in_view, NUM_LEVELS, dim=1)  # [Q, L]
        loc = base[None, :, None, :, None] + off * 0.05
        attn = torch.where(vis[None, :, None, :, None], attn, -1e9)
        attn = torch.softmax(attn.reshape(B, Q, H, L * P), -1).reshape(B, Q, H, L, P)
        # queries behind every camera keep zero weight
        attn = attn * vis.any(-1)[None, :, None, None, None]
        flat_shapes = [hw for cam in shapes for hw in cam]
        out = ms_deform_attn(value.reshape(B, value.shape[1], H, D // H), flat_shapes, loc,
                             attn)
        return self.out_proj(out)


class MultiHeadDotProductAttention(nn.Module):
    """flax nn.MultiHeadDotProductAttention (qkv_features = dim, no mask,
    no dropout) in plain matmuls and a softmax: `query`, `key`, `value`
    projections to heads of dim // num_heads, scaled dot products, `out`.
    Keys and values both come from `kv`."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(dim, dim))

    def forward(self, x, kv):
        B, Tq, D = x.shape
        H = self.num_heads
        heads = lambda t: t.reshape(B, t.shape[1], H, D // H).transpose(1, 2)  # noqa: E731
        q = heads(self.query(x)) / math.sqrt(D // H)
        k, v = heads(self.key(kv)), heads(self.value(kv))
        w = torch.softmax(q @ k.transpose(-1, -2), -1)
        return self.out((w @ v).transpose(1, 2).reshape(B, Tq, D))


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attention(LN0(x), LN1(kv)), then x + MLP(LN2(x));
    a self-attention block (kv None) normalises x twice, with LN0 and LN1."""

    def __init__(self, dim=64, num_heads=4):
        super().__init__()
        self.LayerNorm_0 = _ln(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, num_heads)
        self.LayerNorm_1 = _ln(dim)
        self.LayerNorm_2 = _ln(dim)
        self.Dense_0 = Dense(dim, dim * 4)
        self.Dense_1 = Dense(dim * 4, dim)

    def forward(self, x, kv=None):
        kv = x if kv is None else kv
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), self.LayerNorm_1(kv))
        return x + self.Dense_1(torch.relu(self.Dense_0(self.LayerNorm_2(x))))


class DetectionHead(nn.Module):
    """Per-BEV-cell single-anchor detection: centre offset, log-size, yaw
    and objectness; `decode` applies rotated NMS (ops.e2e.nms_rotated)."""

    def __init__(self, dim=64):
        super().__init__()
        self.reg = Dense(dim, 6)  # dx, dy, logw, logl, sin, cos
        self.cls = Dense(dim, 1)
        self.register_buffer("centers", torch.from_numpy(bev_cell_centers()), persistent=False)

    def forward(self, bev):  # [B, Q, D]
        reg = self.reg(bev)
        score = self.cls(bev)[..., 0]
        cell = torch.tensor([(BEV_X1 - BEV_X0) / BEV_W, (BEV_Y1 - BEV_Y0) / BEV_H],
                            device=bev.device)
        xy = self.centers + torch.tanh(reg[..., :2]) * cell
        wl = torch.exp(torch.clamp(reg[..., 2:4], -2.0, 2.0)) * 2.0
        yaw = torch.atan2(reg[..., 4], reg[..., 5])
        return torch.cat([xy, wl, yaw[..., None]], -1), score  # (cx, cy, w, l, yaw)

    @staticmethod
    def decode(boxes, score, top_k=16, iou_thr=0.5):
        """NMS + top-k: ([B, k, 5] boxes, [B, k] scores; suppressed -> 0)."""
        p = torch.sigmoid(score)
        ps = torch.where(nms_rotated(boxes, p, iou_threshold=iou_thr), p, 0.0)
        order = torch.argsort(-ps, dim=-1, stable=True)[:, :top_k]
        return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 5)),
                torch.gather(ps, 1, order))


class WaypointGRU(nn.Module):
    """Autoregressive waypoint decoder conditioned on the target point."""

    def __init__(self, z_dim=128, hidden=65):
        super().__init__()
        self.init = Dense(z_dim, hidden)
        self.cell = GRUCell(hidden, hidden)
        self.in_proj = Dense(4, hidden)
        self.delta = Dense(hidden, 2)

    def forward(self, z, target):
        h = self.init(z)
        wp = torch.zeros((z.shape[0], 2), device=z.device)
        out = []
        for _ in range(PRED_LEN):
            h = self.cell(h, self.in_proj(torch.cat([wp, target], -1)))
            wp = wp + self.delta(h)
            out.append(wp)
        return torch.stack(out, 1)  # [B, T, 2]


def _rows(x, idx):
    """x [B, N, D] gathered at idx [B, ...] -> [B, ..., D]."""
    B = x.shape[0]
    flat = idx.reshape(B, -1).long()
    return torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1])).reshape(
        idx.shape + x.shape[-1:])


class E2EModel(nn.Module):
    """variant in {'uniad', 'vad', 'sparsedrive'}. forward(imgs [B, N_CAM,
    H, W, C], target [B, 2], speed [B]) -> {'pred_wp', 'det_boxes',
    'det_scores', ...}."""

    def __init__(self, variant="uniad", dim=64, num_heads=4, num_modes=16, num_instances=16):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"E2E variant {variant!r} is none of {VARIANTS}")
        self.variant, self.dim = variant, dim
        self.num_modes, self.num_instances = num_modes, num_instances
        D = dim
        self.backbone = CameraBackbone(D, num_heads)
        self.ctx = Dense(3, D)
        if variant == "sparsedrive":
            Qd = num_instances
            self.anchors = nn.Parameter(torch.zeros(Qd, 5))
            self.inst_emb = nn.Parameter(torch.zeros(Qd, D))
            for i in range(2):
                self.add_module(f"agg_w_{i}", Dense(D, 5 * NUM_CAMERAS * NUM_LEVELS))
                self.add_module(f"agg_proj_{i}", Dense(D, D))
                self.add_module(f"knn_msg_{i}", Dense(D, D))
                self.add_module(f"inst_{i}", TransformerBlock(D, num_heads))
                self.add_module(f"refine_{i}", Dense(D, 5))
            self.cls = Dense(D, 1)
            self.plan_query = nn.Parameter(torch.zeros(1, D))
            self.plan = TransformerBlock(D, num_heads)
            self.wp = WaypointGRU(2 * D)
            return
        # the dense BEV of uniad and vad
        Q = BEV_H * BEV_W
        self.bev_query = nn.Parameter(torch.zeros(Q, D))
        self.pillar_splat = Dense(NUM_CHANNELS, D)
        self.l0_splat = Dense(D, D)
        for i in range(2):
            self.add_module(f"sca_{i}", BEVCrossAttention(D, num_heads))
            self.add_module(f"self_{i}", TransformerBlock(D, num_heads))
        self.det = DetectionHead(D)
        if variant == "uniad":
            self.track_query = nn.Parameter(torch.zeros(num_instances, D))
            self.track_0 = TransformerBlock(D, num_heads)
            self.track_1 = TransformerBlock(D, num_heads)
            self.motion = Dense(D, D)
            self.plan_query = nn.Parameter(torch.zeros(1, D))
            self.plan_m = TransformerBlock(D, num_heads)
            self.plan_b = TransformerBlock(D, num_heads)
            self.wp = WaypointGRU(2 * D)
        else:
            self.ego_query = nn.Parameter(torch.zeros(1, D))
            self.ego_0 = TransformerBlock(D, num_heads)
            self.ego_1 = TransformerBlock(D, num_heads)
            self.traj_modes = nn.Parameter(torch.zeros(num_modes, PRED_LEN, 2))
            self.mode_emb = Dense(PRED_LEN * 2, D)
            self.score_in = Dense(2 * D, D)
            self.refine = Dense(2 * D, PRED_LEN * 2)
        self._static_geometry()

    def _static_geometry(self):
        """The rig's ego-frame geometry, which no state changes: each
        camera pixel's ground point and hit mask (the pillar splat), the
        BEV cell of each level-0 feature (-1 outside), and the BEV cell
        centres' projections into the cameras. Buffers, made once and
        moved with the model."""
        pts, hit = pixel_ground_table()
        N = NUM_CAMERAS * IMG_H * IMG_W
        xyz = torch.cat([pts.reshape(N, 2), torch.zeros(N, 1)], -1)
        vx = (BEV_X1 - BEV_X0) / BEV_W
        vy = (BEV_Y1 - BEV_Y0) / BEV_H
        p0, h0 = pts[:, ::2, ::2], hit[:, ::2, ::2]  # the level-0 grid (H/2)
        ix = torch.floor((p0[..., 0] - BEV_X0) / vx).to(torch.int32)
        iy = torch.floor((p0[..., 1] - BEV_Y0) / vy).to(torch.int32)
        ok = h0 & (ix >= 0) & (ix < BEV_W) & (iy >= 0) & (iy < BEV_H)
        base_uv, in_view = project_points(torch.from_numpy(bev_cell_centers()))
        for name, t in (("pix_xyz", xyz), ("pix_hit", hit.reshape(N)),
                        ("l0_cell", torch.where(ok, iy * BEV_W + ix, -1).reshape(-1)),
                        ("base_uv", base_uv), ("in_view", in_view)):
            self.register_buffer(name, t, persistent=False)

    def forward(self, imgs, target, speed):
        value, shapes = self.backbone(imgs)
        ctx = torch.cat([target / 30.0, speed[:, None] / 10.0], -1)
        if self.variant == "sparsedrive":
            return self._sparsedrive(value, shapes, ctx, target)
        bev = self._build_bev(value, shapes, imgs)
        if self.variant == "vad":
            return self._vad(bev, ctx, target)
        return self._uniad(bev, ctx, target)

    # --- dense BEV (uniad / vad) -----------------------------------------
    def _splat_bev(self, imgs):
        """Pillar-splat BEV prior from raw semantic pixels: every camera
        pixel's (static) ego-frame ground point and its semantic channels
        form a pseudo point cloud, hard-voxelized onto the BEV lattice and
        mean-pooled per pillar (ops.e2e.voxelize) -> [B, Q, dim]."""
        B = imgs.shape[0]
        N = self.pix_xyz.shape[0]
        Q = BEV_H * BEV_W
        feats = imgs.reshape(B, N, NUM_CHANNELS)
        valid = self.pix_hit & (feats[..., 0] > 0.5)  # CH_VALID
        points = torch.cat([self.pix_xyz.expand(B, N, 3), feats], -1)
        vx = (BEV_X1 - BEV_X0) / BEV_W
        vy = (BEV_Y1 - BEV_Y0) / BEV_H
        vox, coords, num, vvalid = voxelize(
            points, valid, voxel_size=(vx, vy, 4.0),
            pc_range=(BEV_X0, BEV_Y0, -2.0, BEV_X1, BEV_Y1, 2.0), max_voxels=Q, max_points=8)
        m = torch.arange(vox.shape[2], device=imgs.device) < num[..., None]
        pillar = torch.where(m[..., None], vox[..., 3:], 0.0).sum(2)
        pillar = pillar / torch.clamp(num[..., None], min=1)
        cell = coords[..., 1] * BEV_W + coords[..., 0]  # (iy, ix) row-major
        dense = imgs.new_zeros((B, Q + 1, NUM_CHANNELS)).scatter_add(
            1, torch.where(vvalid, cell, Q).long()[..., None].expand(-1, -1, NUM_CHANNELS),
            torch.where(vvalid[..., None], pillar, 0.0))
        return self.pillar_splat(dense[:, :Q])

    def _scatter_l0(self, value, shapes):
        """Feature-splat BEV prior: level-0 backbone features mean-pooled
        into the BEV cell under each pixel's static ground point
        (ops.e2e.dynamic_scatter_mean) -> [B, Q, dim]."""
        feats, off = [], 0
        for cam in range(NUM_CAMERAS):
            for lvl, (h, w) in enumerate(shapes[cam]):
                if lvl == 0:
                    feats.append(value[:, off:off + h * w])
                off += h * w
        l0 = torch.cat(feats, 1)  # [B, N_CAM * h0 * w0, D]
        return self.l0_splat(dynamic_scatter_mean(l0, self.l0_cell, BEV_H * BEV_W))

    def _build_bev(self, value, shapes, imgs):
        B = value.shape[0]
        bev = self.bev_query.expand(B, -1, -1)
        # the splat priors seed the queries before the deformable refinement
        bev = bev + self._splat_bev(imgs) + self._scatter_l0(value, shapes)
        for i in range(2):
            bev = bev + getattr(self, f"sca_{i}")(bev, value, shapes, self.base_uv,
                                                   self.in_view)
            bev = getattr(self, f"self_{i}")(bev)
        return bev

    def _uniad(self, bev, ctx, target):
        B = bev.shape[0]
        boxes, score = self.det(bev)
        # track queries attend the BEV (det -> track -> motion chain)
        track = self.track_query.expand(B, -1, -1)
        for i in range(2):
            track = getattr(self, f"track_{i}")(track, kv=bev)
        motion = self.motion(track)
        # the ego plan query attends motion and BEV
        plan = self.plan_m(self.plan_query.expand(B, -1, -1), kv=motion)
        plan = self.plan_b(plan, kv=bev)[:, 0]
        wp = self.wp(torch.cat([plan, self.ctx(ctx)], -1), target)
        return {"pred_wp": wp, "det_boxes": boxes, "det_scores": score}

    def _vad(self, bev, ctx, target):
        B = bev.shape[0]
        boxes, score = self.det(bev)
        ego = self.ego_query.expand(B, -1, -1)
        for i in range(2):
            ego = getattr(self, f"ego_{i}")(ego, kv=bev)
        ego = ego[:, 0]

        # trajectory vocabulary: learned end-pose modes, scored by the ego
        # query and a collision prior pooled under each mode's end box from
        # the BEV objectness map (roi_align_rotated)
        modes = self.traj_modes
        K = modes.shape[0]
        mode_emb = self.mode_emb(modes.reshape(K, -1))
        z = self.score_in(torch.cat([ego, self.ctx(ctx)], -1))
        logits = torch.einsum("bd,kd->bk", z, mode_emb) / math.sqrt(self.dim)

        obj_map = torch.sigmoid(score).reshape(B, BEV_H, BEV_W, 1)
        ends = modes[:, -1]  # [K, 2] ego frame -> BEV pixel coordinates
        px = (ends[:, 1] - BEV_Y0) / (BEV_Y1 - BEV_Y0) * BEV_W
        py = (ends[:, 0] - BEV_X0) / (BEV_X1 - BEV_X0) * BEV_H
        head = torch.atan2(modes[:, -1, 1] - modes[:, -2, 1], modes[:, -1, 0] - modes[:, -2, 0])
        rois = torch.stack([px, py, torch.full_like(px, 2.0), torch.full_like(px, 4.0), head], -1)
        pooled = roi_align_rotated(obj_map, rois, out_size=2)  # [B, K, 2, 2, 1]
        logits = logits - 4.0 * pooled.mean((-1, -2, -3))

        sel = torch.softmax(logits, -1)
        soft_wp = torch.einsum("bk,ktc->btc", sel, modes)
        hard_wp = modes[torch.argmax(logits, -1)]
        refine = self.refine(torch.cat([z, ego], -1)).reshape(B, PRED_LEN, 2)
        return {"pred_wp": hard_wp + refine, "pred_wp_soft": soft_wp + refine,
                "mode_logits": logits, "det_boxes": boxes, "det_scores": score}

    # --- sparse (sparsedrive) --------------------------------------------
    def _sparsedrive(self, value, shapes, ctx, target):
        B = value.shape[0]
        Qd, D = self.num_instances, self.dim
        inst = self.inst_emb.expand(B, -1, -1)
        boxes = self.anchors.expand(B, -1, -1)
        box_scale = torch.tensor([2.0, 2.0, 0.2, 0.2, 0.1], device=value.device)
        for i in range(2):
            # key points: the centre and 4 corners of each anchor, projected
            uv, vis = project_points(self._key_points(boxes))  # [B, Qd, 5, N_CAM, (2)]
            loc = uv.reshape(B, Qd * 5, NUM_CAMERAS, 1, 2).expand(-1, -1, -1, NUM_LEVELS, -1)
            w = getattr(self, f"agg_w_{i}")(inst).reshape(B, Qd * 5, NUM_CAMERAS, NUM_LEVELS)
            w = torch.softmax(w, -1) * vis.reshape(B, Qd * 5, NUM_CAMERAS, 1)
            feat = deformable_aggregation(value, shapes, loc, w)  # [B, Qd*5, D]
            inst = inst + getattr(self, f"agg_proj_{i}")(feat.reshape(B, Qd, 5, D).mean(2))
            # sparse instance interaction: message passing over each
            # instance's 4 nearest neighbours in BEV (ops.e2e.knn)
            centers = boxes[..., :2].detach()
            nb = knn(centers, centers, 4)
            inst = inst + getattr(self, f"knn_msg_{i}")(_rows(inst, nb).mean(2))
            inst = getattr(self, f"inst_{i}")(inst)
            boxes = boxes + getattr(self, f"refine_{i}")(inst) * box_scale

        score = self.cls(inst)[..., 0]
        # 3D-NMS detection decode: (cx, cy, w, l, yaw) lifted to 7-dof boxes
        # and greedily suppressed on 3D IoU (ops.e2e.nms3d)
        zc = torch.full(boxes.shape[:-1] + (1,), 0.9, device=boxes.device)
        b7 = torch.cat([boxes[..., :2], zc, boxes[..., 2:4], torch.full_like(zc, 1.8),
                        boxes[..., 4:5]], -1).detach()
        det_keep = nms3d(b7, score.detach(), 0.3)

        # plan context: spatially diverse instances by furthest-point
        # sampling over the centres, the high-score half eligible
        s = torch.sort(score.detach(), -1).values
        mid = (Qd - 1) / 2
        median = (s[:, math.floor(mid)] + s[:, math.ceil(mid)]) * 0.5  # jnp.median
        fps_idx = furthest_point_sample(boxes[..., :2].detach(), min(8, Qd),
                                        valid=score.detach() >= median[:, None])
        plan = self.plan(self.plan_query.expand(B, -1, -1), kv=_rows(inst, fps_idx))[:, 0]
        wp = self.wp(torch.cat([plan, self.ctx(ctx)], -1), target)
        return {"pred_wp": wp, "det_boxes": boxes, "det_scores": score, "det_keep": det_keep}

    @staticmethod
    def _key_points(boxes):
        cx, cy, w, l, yaw = boxes.unbind(-1)
        c, s = torch.cos(yaw), torch.sin(yaw)
        zero = torch.zeros_like(w)
        dx = torch.stack([zero, l, -l, l, -l], -1) * 0.5
        dy = torch.stack([zero, w, w, -w, -w], -1) * 0.5
        x = cx[..., None] + dx * c[..., None] - dy * s[..., None]
        y = cy[..., None] + dx * s[..., None] + dy * c[..., None]
        return torch.stack([x, y], -1)  # [..., 5, 2]


@torch.no_grad()
def init_e2e_weights(model: E2EModel, gen: torch.Generator) -> E2EModel:
    """Fresh weights drawn from `gen` (a CPU generator, so a seed gives the
    same weights on every device) at flax's default scales: linear and
    convolution kernels normal with std 1/sqrt(fan in), biases 0, layer
    norms 1 and 0; the queries and embeddings normal with std 0.02, the
    trajectory vocabulary with std 0.5, the anchors uniform over the BEV
    extent, sizes 1.5-2.5 x 3.5-5.5 m and yaws within 0.3 rad."""
    lo = torch.tensor([BEV_X0, BEV_Y0, 1.5, 3.5, -0.3])
    hi = torch.tensor([BEV_X1, BEV_Y1, 2.5, 5.5, 0.3])
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "anchors":
            p.copy_(lo + (hi - lo) * torch.rand(p.shape, generator=gen))
        elif leaf == "traj_modes":
            p.copy_(0.5 * torch.randn(p.shape, generator=gen))
        elif leaf in ("bev_query", "track_query", "plan_query", "ego_query", "inst_emb"):
            p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        elif leaf == "weight" and p.dim() >= 2:
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p[0].numel()))
        else:
            p.fill_(1.0 if leaf == "weight" else 0.0)  # biases, layer norms
    return model
