"""The E2E stacks' vendored ops (rift_tpu_torch/ops/e2e.py) against the JAX
package's (rift_tpu/ops/e2e.py), on the CPU, on numpy-seeded inputs.

The JAX functions are written for one sample and vmapped by their callers;
the port's take leading batch dimensions and run their greedy loops (NMS,
furthest-point sampling) for every row at once, so each batched port call
is held against the JAX function row by row.

Tolerances: the bilinear samplers (ms_deform_attn, deformable_aggregation,
roi_align, roi_align_rotated) and the rotated-box IoUs 1e-5 (atol and
rtol); masks and indices (nms_rotated, nms3d, voxelize, the counts of
dynamic_scatter_mean, knn, furthest_point_sample) exactly, and voxelize's
point rows bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ops import e2e as jops
from rift_tpu_torch.ops import e2e as tops
from torch_parity import one_torch_thread

TOL = dict(atol=1e-5, rtol=1e-5)
B = 3  # batch rows of the port's batched calls

# the E2E models' shapes: 2 levels of each of 6 cameras (12 x 24, 6 x 12)
LEVELS = [(12, 24), (6, 12)]
CAM_SHAPES = [LEVELS] * 6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rand_boxes(r, shape, spread=6.0):
    """(cx, cy, w, h, angle) boxes with a few exact duplicates and tied
    scores, so that the NMS order and its suppression both matter."""
    b = np.concatenate([r.uniform(-spread, spread, shape + (2,)),
                        r.uniform(1.0, 4.0, shape + (2,)),
                        r.uniform(-np.pi, np.pi, shape + (1,))], -1).astype(np.float32)
    b[..., 1, :] = b[..., 0, :]  # an exact duplicate
    s = r.random(shape).astype(np.float32)
    s[..., 3] = s[..., 2]  # a tie
    return b, s


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX ops under jit, one compile per function and shape."""
    return {
        "ms_deform_attn": jax.jit(jax.vmap(
            lambda v, loc, w: jops.ms_deform_attn(v[None], LEVELS * 6, loc[None], w[None])[0])),
        "deformable_aggregation": jax.jit(jax.vmap(
            lambda f, loc, w: jops.deformable_aggregation(f[None], CAM_SHAPES, loc[None],
                                                          w[None])[0])),
        "box_iou_rotated": jax.jit(jops.box_iou_rotated),
        "nms_rotated": jax.jit(jops.nms_rotated, static_argnums=2),
        "boxes_iou3d": jax.jit(jops.boxes_iou3d),
        "nms3d": jax.jit(jops.nms3d, static_argnums=2),
        "dynamic_scatter_mean": jax.jit(jops.dynamic_scatter_mean, static_argnums=2),
        "knn": jax.jit(jops.knn, static_argnums=2),
    }


def test_sampling_ops_match_jax(jax_ops):
    """ms_deform_attn at BEVCrossAttention's shapes (4 heads of 16, 12
    levels, 4 points; locations past the maps' edges), deformable_aggregation
    at SparseDrive's, roi_align and roi_align_rotated (one set of rois for
    a batch of maps, and unbatched) with rois past the edges."""
    r = np.random.default_rng(0)
    K = sum(h * w for h, w in LEVELS) * 6
    Q, H, L, P, D = 20, 4, 12, 4, 16
    value = r.normal(0, 1, (B, K, H, D)).astype(np.float32)
    loc = r.uniform(-0.1, 1.1, (B, Q, H, L, P, 2)).astype(np.float32)
    w = r.random((B, Q, H, L, P)).astype(np.float32)
    want = jax_ops["ms_deform_attn"](value, loc, w)
    got = tops.ms_deform_attn(_t(value), LEVELS * 6, _t(loc), _t(w))
    assert got.shape == (B, Q, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    feat = r.normal(0, 1, (B, K, 64)).astype(np.float32)
    loc = r.uniform(-0.1, 1.1, (B, 30, 6, 2, 2)).astype(np.float32)
    w = r.random((B, 30, 6, 2)).astype(np.float32)
    want = jax_ops["deformable_aggregation"](feat, loc, w)
    got = tops.deformable_aggregation(_t(feat), CAM_SHAPES, _t(loc), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    maps = r.random((B, 16, 16, 3)).astype(np.float32)
    x1y1 = r.uniform(-3, 14, (9, 2))
    rois = np.concatenate([x1y1, x1y1 + r.uniform(0.5, 6, (9, 2))], -1).astype(np.float32)
    rrois = np.concatenate([r.uniform(-2, 18, (9, 2)), r.uniform(0.5, 5, (9, 2)),
                            r.uniform(-np.pi, np.pi, (9, 1))], -1).astype(np.float32)
    for fn, boxes in (("roi_align", rois), ("roi_align_rotated", rrois)):
        for kw in ({"out_size": 2}, {"out_size": 3, "sampling_ratio": 3, "spatial_scale": 0.5}):
            want = np.stack([np.asarray(getattr(jops, fn)(jnp.asarray(m), jnp.asarray(boxes),
                                                          **kw)) for m in maps])
            got = getattr(tops, fn)(_t(maps), _t(boxes), **kw)
            np.testing.assert_allclose(got.numpy(), want, err_msg=fn, **TOL)
            one = getattr(tops, fn)(_t(maps[0]), _t(boxes), **kw)
            np.testing.assert_allclose(one.numpy(), want[0], err_msg=fn, **TOL)


def test_rotated_box_ops_match_jax(jax_ops):
    """box_iou_rotated and boxes_iou3d on boxes that overlap, nest, touch
    and coincide; nms_rotated and nms3d batched, each row's keep mask equal
    to the JAX one's (ties in score and exact duplicates included)."""
    r = np.random.default_rng(1)
    boxes, scores = _rand_boxes(r, (B, 24))
    boxes[0, 5] = [0.0, 0.0, 2.0, 2.0, 0.0]  # nested and axis-aligned
    boxes[0, 6] = [0.0, 0.0, 1.0, 1.0, 0.0]
    boxes[0, 7] = [1.5, 0.0, 1.0, 2.0, 0.0]  # touching box 5's edge
    for b in range(B):
        want = jax_ops["box_iou_rotated"](boxes[b], boxes[b])
        np.testing.assert_allclose(
            tops.box_iou_rotated(_t(boxes[b]), _t(boxes[b])).numpy(), np.asarray(want), **TOL)
    got_iou = tops.box_iou_rotated(_t(boxes), _t(boxes[:, :7]))
    for b in range(B):
        np.testing.assert_allclose(
            got_iou[b].numpy(), np.asarray(jax_ops["box_iou_rotated"](boxes[b], boxes[b, :7])),
            **TOL)
    for thr in (0.1, 0.5):
        keep = tops.nms_rotated(_t(boxes), _t(scores), thr).numpy()
        for b in range(B):
            np.testing.assert_array_equal(
                keep[b], np.asarray(jax_ops["nms_rotated"](boxes[b], scores[b], thr)))
        assert not keep.all() and keep.any()

    b7 = np.concatenate([boxes[..., :2], r.uniform(0, 2, (B, 24, 1)), boxes[..., 2:4],
                         r.uniform(1, 2, (B, 24, 1)), boxes[..., 4:5]], -1).astype(np.float32)
    b7[1, 3, 2] += 5.0  # lifted clear of every other box
    got_iou = tops.boxes_iou3d(_t(b7), _t(b7)).numpy()
    keep = tops.nms3d(_t(b7), _t(scores), 0.3).numpy()
    for b in range(B):
        np.testing.assert_allclose(got_iou[b], np.asarray(jax_ops["boxes_iou3d"](b7[b], b7[b])),
                                   **TOL)
        np.testing.assert_array_equal(keep[b], np.asarray(jax_ops["nms3d"](b7[b], scores[b],
                                                                           0.3)))
    assert keep[1, 3]


def test_point_cloud_ops_match_jax(jax_ops):
    """voxelize (points outside the range, invalid points, voxels that
    overflow max_points, more voxels than max_voxels), every output equal;
    dynamic_scatter_mean's counts exactly and means within 1e-5; knn with
    distance ties and invalid points; furthest_point_sample with and
    without a valid mask, with duplicated points."""
    r = np.random.default_rng(2)
    N, Cf = 400, 5
    pts = np.concatenate([r.uniform(-10, 30, (B, N, 2)), r.uniform(-3, 3, (B, N, 1)),
                          r.normal(0, 1, (B, N, Cf))], -1).astype(np.float32)
    pts[:, :60, :2] = pts[:, :1, :2]  # one crowded voxel: past max_points
    valid = r.random((B, N)) < 0.85
    cfgs = [dict(voxel_size=(4.0, 4.0, 4.0), pc_range=(-8.0, -8.0, -2.0, 24.0, 24.0, 2.0),
                 max_voxels=64, max_points=8),
            dict(voxel_size=(2.0, 2.0, 2.0), pc_range=(-8.0, -8.0, -2.0, 24.0, 24.0, 2.0),
                 max_voxels=40, max_points=4)]  # fewer slots than occupied voxels
    for cfg in cfgs:
        got = tops.voxelize(_t(pts), _t(valid), **cfg)
        for b in range(B):
            want = jops.voxelize(jnp.asarray(pts[b]), jnp.asarray(valid[b]), **cfg)
            for name, g, w in zip(("voxels", "coords", "num", "voxel_valid"), got, want):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(w), err_msg=name)
        assert got[3].any() and (got[2] == cfg["max_points"]).any()
    assert got[3][0].all()  # cfgs[1]: every slot taken, voxels dropped

    vid = r.integers(-1, 30, N).astype(np.int32)  # slots 30-33 stay empty
    got = tops.dynamic_scatter_mean(_t(pts), _t(vid), 34)
    for b in range(B):
        want = jax_ops["dynamic_scatter_mean"](pts[b], vid, 34)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **TOL)
    counts = np.bincount(vid[vid >= 0], minlength=34)
    assert (got[0].numpy()[counts == 0] == 0).all() and (counts == 0).any()

    grid = np.stack(np.meshgrid(np.arange(5.0), np.arange(5.0)), -1).reshape(-1, 2)
    q = np.concatenate([grid[None].repeat(B, 0), r.uniform(0, 4, (B, 7, 2))], 1)
    q = q.astype(np.float32)  # lattice points: equal distances everywhere
    kvalid = r.random((B, q.shape[1])) < 0.8
    got = tops.knn(_t(q), _t(q), 6).numpy()
    got_v = tops.knn(_t(q), _t(q), 6, valid=_t(kvalid)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[b], np.asarray(jax_ops["knn"](q[b], q[b], 6)))
        np.testing.assert_array_equal(
            got_v[b], np.asarray(jops.knn(jnp.asarray(q[b]), jnp.asarray(q[b]), 6,
                                          valid=jnp.asarray(kvalid[b]))))

    fps_pts = np.concatenate([q, q[:, :5]], 1)  # duplicated points
    fvalid = r.random(fps_pts.shape[:2]) < 0.6
    for n in (8, 12):
        got = tops.furthest_point_sample(_t(fps_pts), n).numpy()
        got_v = tops.furthest_point_sample(_t(fps_pts), n, valid=_t(fvalid)).numpy()
        for b in range(B):
            np.testing.assert_array_equal(
                got[b], np.asarray(jops.furthest_point_sample(jnp.asarray(fps_pts[b]), n)))
            np.testing.assert_array_equal(
                got_v[b], np.asarray(jops.furthest_point_sample(
                    jnp.asarray(fps_pts[b]), n, valid=jnp.asarray(fvalid[b]))))
