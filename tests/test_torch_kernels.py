"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import neither jax nor rift_tpu (the card's machine has
neither), so they run there without the JAX test configuration:

    python -m pytest tests/test_torch_kernels.py -m cuda -q --noconftest

Without a CUDA device every test here but the replay's own checks skips.
Tolerances: f32 attention
1e-5 (3xTF32 products on the tensor cores, f32-accurate, summed in
another order), at the main path's shapes and at every tile edge;
PointNet atol 2e-4 as the JAX package's own kernel test (a 512-deep
f32 product chain; without the layer norms the outputs reach ~10^3,
hence also rtol 1e-5); bf16 attention 2e-2 (the weights are rounded to
bf16 before the AV product). Retrack: each step of
the kernel's rollout, replayed through the plain version, within 1e-4
away from near-ties (the two sum the PID windows and the speed
polynomials in another order, so a threshold met on one side only sends
a candidate along another path: see test_retrack_kernel_matches_plain);
refline 1e-5 with the nearest indices equal (candidate
points sit off the line's midpoints, so no two line points tie, or, in
the "ties" cases, on them with every distance exact: the lower index
wins in both); the
HistoryEncoder stage 1e-4 at the main path's N = 1536 rows, at its
chunk layout's edges and at shapes beyond the model's levels (two f32
LocalBlocks, products up to 384 deep summed in another order), and the
whole-encoder kernel 1e-4 there (six blocks, the convolutions and the
FPN), also at an act call's rows on legacy tokens (N = 6144; the
PointNet there at its 12288 map polygons, masked whole). The launch
counters show which kernels a path takes. The
gradients through the kernels' autograd Functions equal the plain
versions' gradients (both backwards recompute through the plain version;
the forward outputs feed nothing else).
"""

import numpy as np
import pytest
import torch

from rift_tpu_torch.ops.attention import fused_attention, fused_attention_ref
from rift_tpu_torch.ops.history import band_rpb_bias, history_encoder, history_encoder_ref
from rift_tpu_torch.ops.history import local_stage, local_stage_ref
from rift_tpu_torch.ops.points import points_encoder, points_forward_ref
from rift_tpu_torch.ops.refline import refline_matrices, refline_matrices_ref
from rift_tpu_torch.geometry.se2 import rotate
from rift_tpu_torch.ops.retrack import FUTURE_LEN, retrack_rollout, retrack_rollout_ref
from rift_tpu_torch.sim import dynamics, pid
from torch_parity import ATTN_CASES, STAGE_LEVELS, attn_inputs, points_weights, stage_inputs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_kernel_matches_plain(cuda_device, case, dtype):
    B, Tq, Tk, D, H = ATTN_CASES[case]
    q, k, v, bias, kpad = (
        torch.from_numpy(a).to(cuda_device) for a in attn_inputs(B, Tq, Tk, D, H)
    )
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = fused_attention(q, k, v, bias, kpad, H)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        got.float(), fused_attention_ref(q, k, v, bias, kpad, H).float(),
        atol=atol, rtol=0,
    )


# the attention kernel's tile edges: (B, Tq, Tk, D, H, layout). Query
# tiles are 16 rows and key tiles 16 keys, so Tq and Tk cross them
# (Tq = 300 takes the loop of 8 warps over 19 tiles); "packed" slices q, k
# and v out of one [B, T, 3D] projection (Tq = Tk), "kv" k and v out of one
# [B, Tk, 2D]; D/H = 15 and 12 take the element-wise staging; sequences of
# <= 4 tokens go four to a warp's 16 rows, at B = 2101 (8404 heads) with a
# ragged last block and at 5 x 3 heads with an empty slot in the last warp
ATTN_EDGES = [
    (5, 1, 1, 128, 4, "sep"), (5, 1, 6, 128, 4, "sep"), (7, 4, 4, 128, 4, "packed"),
    (6, 12, 12, 64, 4, "packed"), (3, 12, 97, 128, 4, "kv"), (3, 48, 97, 128, 4, "kv"),
    (2, 48, 128, 128, 4, "kv"), (3, 97, 97, 128, 4, "packed"), (2, 97, 128, 64, 4, "kv"),
    (2, 300, 33, 128, 4, "kv"), (3, 17, 23, 60, 4, "sep"), (3, 20, 20, 48, 4, "packed"),
    (2101, 4, 4, 128, 4, "packed"), (2101, 3, 2, 128, 4, "sep"), (5, 4, 4, 96, 3, "packed"),
]


# head dims 33..64 (the kernel's second instantiation): Tk at 1 (four
# short sequences to a warp), 16, 17 and 128 (the f32 staging above 48 KB
# of shared memory; Tq = 130 takes a second pass of the 8 warps), PlanT's
# 19 tokens at its ego's D = 512, H = 8 and its recognizer's D = 128, H = 4
# (head dim 32), and D/H = 60 and 33 (element-wise staging in bf16; an odd
# head dim stores element by element)
ATTN_DH64_EDGES = [
    (5, 1, 1, 128, 2, "sep"), (6, 16, 16, 256, 4, "packed"), (4, 17, 17, 512, 8, "packed"),
    (2, 48, 128, 128, 2, "kv"), (2, 130, 128, 256, 4, "kv"), (3, 19, 19, 512, 8, "packed"),
    (3, 19, 19, 128, 4, "packed"), (3, 20, 20, 120, 2, "sep"), (3, 17, 23, 66, 2, "sep"),
]


def _attention_edge(device, case, dtype):
    B, Tq, Tk, D, H, layout = case
    q, k, v, bias, kpad = (torch.from_numpy(a).to(device)
                           for a in attn_inputs(B, Tq, Tk, D, H, seed=3))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if layout == "packed":
        q, k, v = torch.cat([q, k, v], -1).split(D, -1)
    elif layout == "kv":
        k, v = torch.cat([k, v], -1).split(D, -1)
    assert layout == "sep" or k.stride(1) > D
    got = fused_attention(q, k, v, bias, kpad, H)
    torch.cuda.synchronize()
    ref = fused_attention_ref(q, k, v, bias, kpad, H)
    assert torch.isfinite(got).all()
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_EDGES, ids=lambda c: "x".join(map(str, c)))
def test_attention_kernel_tile_edges(cuda_device, case, dtype):
    """Every row tail and key tail, strided slices of packed projections,
    a fully masked row (batch row 0), in f32 (1e-5) and bf16 (2e-2)."""
    _attention_edge(cuda_device, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_DH64_EDGES, ids=lambda c: "x".join(map(str, c)))
def test_attention_kernel_head_dim_64(cuda_device, case, dtype):
    """Head dims up to 64 at the key tails, packed and strided q/k/v and a
    fully masked row (batch row 0), in f32 (1e-5) and bf16 (2e-2)."""
    _attention_edge(cuda_device, case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("has_ln", [True, False])
def test_points_kernel_matches_plain(cuda_device, has_ln):
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.normal(0, 2.0, (300, 120, 6)).astype(np.float32))
    mask = torch.from_numpy(r.random((300, 120)) < 0.7)
    mask[5] = False
    w = [torch.from_numpy(a).to(cuda_device) for a in points_weights(2, 6, 128)]
    x, mask = x.to(cuda_device), mask.to(cuda_device)
    got = points_encoder(x, mask, w, 128, has_ln)
    torch.cuda.synchronize()
    ref = points_forward_ref(x, mask, w, has_ln)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N, P, kind",
    [(1003, 20, "all"), (300, 1, "random"), (300, 17, "random")],
    ids=["P20-every-point-valid", "P1-all-masked-row", "P17-all-masked-row"],
)
def test_points_kernel_tile_edges(cuda_device, N, P, kind):
    """The edges of the kernel's packing of whole rows into 128-point
    tiles: six rows of 20 points a tile with N not a multiple of six, and
    16 rows of one point or seven of 17 with masked points and an
    all-masked row."""
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.normal(0, 2.0, (N, P, 10)).astype(np.float32))
    if kind == "all":
        mask = torch.ones(N, P, dtype=torch.bool)
    else:
        mask = torch.from_numpy(r.random((N, P)) < 0.7)
        mask[5] = False
    w = [torch.from_numpy(a).to(cuda_device) for a in points_weights(3, 10, 128)]
    x, mask = x.to(cuda_device), mask.to(cuda_device)
    got = points_encoder(x, mask, w, 128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, points_forward_ref(x, mask, w), atol=2e-4, rtol=1e-5)


@pytest.mark.cuda
def test_points_kernel_legacy_map_shape(cuda_device):
    """The map-polygon launch of an act call on legacy (per-CBV) tokens at
    the bench configuration: N = 64 scenarios x 3 CBVs x 64 polygons of
    20 points and 10 channels, polygons in or out whole as the features'
    masks (a slot past the lanes in range), a quarter of them out: those
    give exactly 0 from both, the rest within the file's PointNet bound."""
    r = np.random.default_rng(11)
    N = 64 * 3 * 64
    x = torch.from_numpy(r.normal(0, 2.0, (N, 20, 10)).astype(np.float32)).to(cuda_device)
    out = torch.from_numpy(r.random(N) < 0.25).to(cuda_device)
    mask = (~out)[:, None].expand(N, 20).contiguous()
    w = [torch.from_numpy(a).to(cuda_device) for a in points_weights(4, 10, 128)]
    got = points_encoder(x, mask, w, 128)
    torch.cuda.synchronize()
    ref = points_forward_ref(x, mask, w)
    assert out.any() and not got[out].any() and not ref[out].any()
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-5)


def _replay(ref_pos, trace, dt=0.1):
    """Steps the plain version once from every state of `trace` (center
    [G, T, 2], heading [G, T], speed [G, T] of a rollout along ref_pos,
    the tracker's windows filled from the trace's own states). Returns the
    one-step error [G, T-1], the largest difference between the trace's
    next state and that step, and the relative margins [G, T-1] of the
    step's discrete decisions: how far the nearest path point is from a
    tie with the second nearest, the aim point from a tie between the two
    candidates, and the speed from the brake, stopped and throttle-floor
    thresholds (inf where a decision does not matter). Points at one
    location (a path that stands still or doubles back) tie exactly in
    every rounding, and both versions take the first of them: the nearest
    point's margin is to the nearest point elsewhere, and two aim
    candidates at one location are no tie."""
    center, heading, speed = trace
    G, T = heading.shape
    tracker = pid.TrackerState.zeros((G,), device=ref_pos.device)
    closest = torch.zeros(G, dtype=torch.long, device=ref_pos.device)
    ahead = torch.arange(FUTURE_LEN, device=ref_pos.device)
    inf = torch.full((G,), float("inf"), device=ref_pos.device)
    errs, margins = [], {k: [] for k in ("closest", "aim", "brake_speed", "brake_ratio",
                                         "stopped", "throttle")}
    for t in range(T - 1):
        pos, hd, v = center[:, t], heading[:, t], speed[:, t]
        m_closest = inf
        if t:
            d2 = ((ref_pos - pos[:, None]) ** 2).sum(-1)
            closest = torch.argmin(d2, dim=-1)
            nearest = torch.gather(ref_pos, 1, closest[:, None, None].expand(G, 1, 2))
            elsewhere = d2.masked_fill((ref_pos == nearest).all(-1), float("inf"))
            d_min = d2.gather(1, closest[:, None])[:, 0]
            m_closest = (elsewhere.amin(-1) - d_min) / d_min.clamp(min=1.0)
        idx = torch.clamp(closest[:, None] + ahead, max=T - 1)
        pts = torch.gather(ref_pos, 1, idx[..., None].expand(G, FUTURE_LEN, 2))
        local = rotate(pts - pos[:, None], -hd[:, None])
        action, tracker = pid.track_step(tracker, local, v)
        npos, nhd, nv = dynamics.bicycle_step(pos, hd, v, action, dt)
        errs.append(torch.stack([(npos - center[:, t + 1]).abs().amax(-1),
                                 (nhd - heading[:, t + 1]).abs(),
                                 (nv - speed[:, t + 1]).abs()]).amax(0))
        wp = local[:, 9::10]
        desired = torch.linalg.norm(wp[:, 1:] - wp[:, :-1], dim=-1).mean(-1)
        aim = torch.clamp(pid.AIM_ALPHA * v + pid.AIM_BETA, pid.MIN_AIM_DIS, pid.MAX_AIM_DIS)
        norm = torch.linalg.norm(wp[:, :2], dim=-1)
        braking = action[:, 2] >= 0.5
        free = lambda m: torch.where(braking, inf, m)
        one_point = (pts[:, 9] == pts[:, 19]).all(-1)
        margins["closest"].append(m_closest)
        margins["aim"].append(free(torch.where(
            one_point, inf, ((norm[:, 1] - aim).abs() - (norm[:, 0] - aim).abs()).abs() / aim)))
        margins["brake_speed"].append((desired - pid.BRAKE_SPEED).abs() / pid.BRAKE_SPEED)
        margins["brake_ratio"].append(
            (v / desired.clamp(min=1e-4) - pid.BRAKE_RATIO).abs() / pid.BRAKE_RATIO)
        margins["stopped"].append(free((v - 0.01).abs() / 0.01))
        margins["throttle"].append(free((action[:, 0] - dynamics.THROTTLE_MIN_EFFECT).abs()))
    return torch.stack(errs, 1), {k: torch.stack(m, 1) for k, m in margins.items()}


def test_replay_of_the_plain_rollout_is_exact():
    """On the CPU: the replay of the plain version's own rollout reproduces
    every step exactly, so a one-step error on the card is the kernel's."""
    args = [torch.from_numpy(a) for a in _retrack_inputs(np.random.default_rng(3), 40, 40)]
    err, margins = _replay(args[0], retrack_rollout_ref(*args))
    assert err.max().item() == 0.0
    assert set(margins) == {"closest", "aim", "brake_speed", "brake_ratio", "stopped", "throttle"}
    assert all(m.shape == (40, 39) and (m >= 0).all() for m in margins.values())


def _retrack_inputs(r, G, T, kind="curves"):
    """G paths of T points, 0-18 m/s, gentle curvature, anywhere in a
    200 m square, and a start heading and speed each. "standing": every
    point of a path at its start; "doubled": a path that turns back
    halfway and retraces its own points (point t at point T-1-t);
    "tiled": the first 300 "curves" candidates again and again."""
    if kind == "tiled":
        return [a[np.arange(G) % 300] for a in _retrack_inputs(r, 300, T)]
    t = np.arange(T, dtype=np.float32)
    yaw = r.uniform(-np.pi, np.pi, (G, 1)) + r.uniform(-0.02, 0.02, (G, 1)) * t
    step = r.uniform(0.0, 1.8, (G, 1))
    d = np.stack([np.cos(yaw), np.sin(yaw)], -1) * step[..., None]
    pos = r.uniform(0, 200, (G, 1, 2)) + np.cumsum(d, 1) - d[:, :1]
    if kind == "standing":
        pos = np.repeat(pos[:, :1], T, 1)
    elif kind == "doubled":
        pos = pos[:, np.minimum(np.arange(T), T - 1 - np.arange(T))]
    return [np.ascontiguousarray(a, np.float32) for a in (pos, yaw[:, 0], r.uniform(0, 12, G))]


def test_replay_exempts_coincident_points():
    """On the CPU: on paths that stand still or double back, whose points
    tie exactly with their twins at every step, the replay of the plain
    rollout is exact and reports no exact closest-point tie (a standing
    path none at all)."""
    for kind in ("standing", "doubled"):
        args = [torch.from_numpy(a)
                for a in _retrack_inputs(np.random.default_rng(5), 24, 40, kind)]
        err, margins = _replay(args[0], retrack_rollout_ref(*args))
        assert err.max().item() == 0.0, kind
        assert (margins["closest"] > 0).all(), kind
        if kind == "standing":
            assert margins["closest"].isinf().all()


# (G, T, kind) of the retrack card test: the main path's T = 40 with the
# ragged block tails of G = 1, 5 and 129 (4 blocks of 32 candidates and
# one more) and, at G = 9219, the 300 candidates of the first case tiled,
# each of them at many block offsets and tail positions; the T edges 1, 2
# and 12 (aim lookups clamped) and 41, the first past the paths kept in
# registers, where the search reads shared memory; the exact ties of
# paths that stand still or double back, up to T = 256, the longest and
# the one that needs more than 48 KB of shared memory. (Random curved
# paths over hundreds of steps, or thousands of random candidates, break
# this test's share and onset rules through the plain version's other
# rounding alone, with the bits of the serial kernel as with these:
# near-ties grow with the horizon, and among thousands, or on paths that
# turn back, a candidate can drift past 2e-3 without one. Chip_smoke holds
# 9216 random candidates by the share of diverging ones.)
RETRACK_CASES = [
    (300, 40, "curves"), (1, 40, "curves"), (5, 40, "curves"), (129, 40, "curves"),
    (9219, 40, "tiled"), (300, 1, "curves"), (300, 2, "curves"), (300, 12, "curves"),
    (129, 41, "curves"), (129, 40, "standing"), (129, 40, "doubled"), (129, 256, "standing"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("G,T,kind", RETRACK_CASES)
def test_retrack_kernel_matches_plain(cuda_device, G, T, kind):
    """Free-running, a candidate whose step meets a threshold (a near-tied
    closest point, a brake or throttle-floor test) on one side only takes
    another path from there on, so the kernel and the plain version are
    compared step by step: every step of the kernel's rollout, replayed
    through the plain version from the kernel's own state, agrees within
    1e-4 unless one of the step's decisions lies within 1e-5 (relative)
    of a tie; after the first such step the candidate is not compared
    further, and at most 1% of candidates may meet one. Free-running, a
    candidate that differs by more than 2e-3 (the JAX package's bound for
    its own kernel against the scan) must have met a decision within 1e-4
    of a tie before it parted, and at most 1% may.

    Measured on an H100 (80GB HBM3, 700 W): one-step errors at most
    1.5e-5 (an ulp of a 200 m coordinate); 2 of 300 candidates meet a
    near-tie in the replay (a brake ratio 1.5e-6 and a closest point
    2.4e-8 from a tie) and stay within 1e-5 free-running; 1 of 300
    (candidate 7) diverges: at step 11 the speed PID's throttle lies
    1.8e-7 from the 0.3 throttle floor along the plain rollout and 5.3e-5
    along the kernel's, on the other side, so one coasts and the other
    follows the throttle polynomial, and the paths part from row 12."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _retrack_inputs(np.random.default_rng(3), G, T, kind)]
    got = retrack_rollout(*args)
    torch.cuda.synchronize()
    if kind == "tiled":  # every copy of a candidate, wherever it sits, gives the same bits
        copies = torch.arange(G, device=cuda_device) % 300
        assert all(torch.equal(x, x[:300][copies]) for x in got)
    ref = retrack_rollout_ref(*args)
    if T == 1:  # the start alone
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        return
    err = torch.stack([(a - b).abs().reshape(G, -1).amax(1) for a, b in zip(got, ref)]).amax(0)
    diverged = err > 2e-3
    print(f"free-running: {int(diverged.sum())} of {G} diverged, max error of the others "
          f"{err[~diverged].max().item():.3g}")

    step_err, margins = _replay(args[0], got)
    _, ref_margins = _replay(args[0], ref)
    gap = torch.stack([(a - b).abs().reshape(G, T, -1).amax(-1) for a, b in zip(got, ref)]).amax(0)
    tie = torch.stack(list(margins.values())).amin(0) < 1e-5
    off = (step_err > 1e-4) & ~tie
    # steps after a candidate's first near-tie are not compared
    after = torch.cumsum(tie.int(), 1) - tie.int() > 0
    parted = tie.any(1)
    print(f"replayed: max one-step error {step_err[~after].max().item():.3g}, "
          f"{int(parted.sum())} candidates meet a near-tie")
    near = lambda ms, g: {k: f"{m[g].min().item():.3g}@{int(m[g].argmin())}" for k, m in ms.items()}
    for g in torch.nonzero(diverged | parted).flatten().tolist():
        t = int(torch.nonzero(tie[g]).min()) if parted[g] else None
        onset = torch.nonzero(gap[g] > 1e-4)
        print(f"candidate {g}: free-running error {err[g].item():.3g} (above 1e-4 from row "
              f"{int(onset.min()) if len(onset) else None}), first near-tie at step {t}, "
              f"smallest margins (value@step) along the kernel's rollout {near(margins, g)}, "
              f"along the plain one {near(ref_margins, g)}")
    assert not (off & ~after).any(), torch.nonzero(off & ~after)[:10].tolist()
    assert parted.float().mean().item() <= 0.01
    # a free-running divergence starts at a step that one of the two
    # rollouts takes within 1e-4 of a tie
    both = torch.stack(list(margins.values()) + list(ref_margins.values())).amin(0)
    for g in torch.nonzero(diverged).flatten().tolist():
        onset = int(torch.nonzero(gap[g] > 1e-4).min())
        assert both[g, :onset].min().item() < 1e-4, g
    assert diverged.float().mean().item() <= 0.01


def _refline_inputs(r, BR, MT, Nr, kind):
    """Lines of Nr points 1 m apart along the x axis (centred on the origin
    past 128 points, so that the plain version's |c|^2 + |r|^2 - 2 c.r
    ranks points 1 m apart without error) and candidate points off the
    line: at x = k + 0.25, where no two line points tie, or for "ties" at
    x = k + 0.5 and y a multiple of 0.5, where every distance is exact and
    a candidate halfway between two valid points ties (the lower index
    wins). Valid points: a prefix of each line ("prefix"), scattered
    ("scattered", and every other line of "ties"), or none ("empty");
    line 3 is empty in every batch."""
    lo = -(Nr // 2) if Nr > 128 else 0
    if kind == "ties":
        cand = np.stack([r.integers(0, max(Nr - 1, 1), (BR, MT)) + 0.5 + lo,
                         0.5 * r.integers(-6, 7, (BR, MT))], -1)
    else:
        cand = np.stack([r.integers(0, max(Nr - 10, 1), (BR, MT)) + 0.25 + lo,
                         r.uniform(-5, 5, (BR, MT))], -1)
    ref = np.stack(np.broadcast_arrays(np.arange(Nr, dtype=np.float32) + lo, np.zeros((BR, 1))), -1)
    valid = np.arange(Nr) < r.integers(1, Nr + 1, (BR, 1))
    if kind in ("scattered", "ties"):
        scattered = r.random((BR, Nr)) < 0.3
        valid = scattered if kind == "scattered" else np.where(np.arange(BR)[:, None] % 2, scattered, True)
    elif kind == "empty":
        valid[:] = False
    valid[3] = False  # an empty line: index 0, as an argmin over all-inf
    return cand, r.uniform(-3, 3, (BR, MT)), ref, r.uniform(-0.1, 0.1, (BR, Nr)), valid


# (BR, MT, Nr, kind) of the refline card test: the main path's MT = 480 (a
# whole number of the kernel's tiles) and Nr = 120, MT's edges 1, 7 and
# 481 (a ragged tile), Nr's 1 and 2048 (the kernel's limit), valid points
# scattered, lines with no valid point, and exact ties
REFLINE_CASES = [
    (64, 480, 120, "prefix"), (64, 1, 120, "prefix"), (64, 7, 120, "prefix"),
    (64, 481, 120, "prefix"), (64, 480, 1, "prefix"), (16, 480, 2048, "prefix"),
    (64, 480, 120, "scattered"), (16, 481, 2048, "scattered"), (64, 480, 120, "empty"),
    (64, 480, 120, "ties"), (16, 7, 2048, "ties"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("BR,MT,Nr,kind", REFLINE_CASES)
def test_refline_kernel_matches_plain(cuda_device, BR, MT, Nr, kind):
    cand, cand_h, ref, ref_h, valid = _refline_inputs(np.random.default_rng(4), BR, MT, Nr, kind)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(cuda_device)
    args = (f(cand), f(cand_h), f(ref), f(ref_h), torch.from_numpy(valid).to(cuda_device))
    dis, ang, idx = refline_matrices(*args, return_index=True)
    torch.cuda.synchronize()
    rdis, rang, ridx = refline_matrices_ref(*args, return_index=True)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(dis, rdis, atol=1e-5, rtol=0)
    torch.testing.assert_close(ang, rang, atol=1e-5, rtol=0)
    if kind == "ties":  # ties there, and the lower index won
        d2 = ((args[0][:, :, None] - args[2][:, None]) ** 2).sum(-1)
        d2 = d2.masked_fill(~args[4][:, None], float("inf"))
        tie = (d2 == d2.amin(-1, keepdim=True)).sum(-1) > 1
        assert tie.any()
        near_x = torch.gather(args[2][..., 0], 1, idx)
        assert (near_x < args[0][..., 0])[tie].all()


@pytest.mark.cuda
def test_attention_function_gradient_matches_plain(cuda_device):
    B, Tq, Tk, D, H = ATTN_CASES["m2m_t12"]
    arrs = [torch.from_numpy(a).to(cuda_device) for a in attn_inputs(B, Tq, Tk, D, H)]
    w = torch.randn(B, Tq, D, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
    grads = []
    for fn in (fused_attention, fused_attention_ref):
        xs = [a.clone().requires_grad_(True) for a in arrs[:4]]
        out = fn(*xs, arrs[4], H)
        assert out.grad_fn is not None
        (out * w).sum().backward()
        grads.append([x.grad for x in xs])
    for g, ref in zip(*grads):
        torch.testing.assert_close(g, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_points_function_gradient_matches_plain(cuda_device):
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.normal(0, 2.0, (64, 20, 10)).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy(r.random((64, 20)) < 0.7).to(cuda_device)
    w = [torch.from_numpy(a).to(cuda_device) for a in points_weights(6, 10, 128)]
    g = torch.from_numpy(r.normal(0, 1, (64, 128)).astype(np.float32)).to(cuda_device)
    grads = []
    for fn in (lambda *a: points_encoder(*a, 128), points_forward_ref):
        xs = [t.clone().requires_grad_(True) for t in (x, *w)]
        out = fn(xs[0], mask, xs[1:])
        assert out.grad_fn is not None
        (out * g).sum().backward()
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _stage_tensors(device, level, N, seed=0):
    T, D, H, window = STAGE_LEVELS[level]
    x, ws, rpb = stage_inputs(seed, N, T, D, H, window)
    to = lambda a: torch.from_numpy(a).to(device)
    biases = [band_rpb_bias(to(p), T, window) for p in rpb]
    return to(x), [to(w) for w in ws], biases, H


def _stage_rows(case, T, D):
    """The row count N of a stage case, from the kernel's chunk at [T, D]
    (G sequences) and the card's SM count (one block each)."""
    from rift_tpu_torch.ops.history import stage_chunk

    G = stage_chunk(T, D)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges = {"G-1": G - 1, "G+1": G + 1, "SMs*G+7": sms * G + 7}
    return edges[case] if case in edges else int(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1536", "1537", "1", "G-1", "G+1", "SMs*G+7", "8192"])
@pytest.mark.parametrize("level", sorted(STAGE_LEVELS))
def test_history_stage_kernel_matches_plain(cuda_device, level, case):
    """The stage kernel at the main path's shape, S*A = 1536 rows, and at
    its layout's edges: a ragged last block (1537 rows), one sequence, one
    less and one more than a chunk of G sequences, a grid of one block per
    SM whose blocks' shares are not whole numbers of chunks (SMs*G+7 rows:
    a share of G+1 walks two chunks), and a fit step's 8192 rows."""
    T, D = STAGE_LEVELS[level][:2]
    x, ws, biases, H = _stage_tensors(cuda_device, level, _stage_rows(case, T, D))
    got = local_stage(x, ws, *biases, H)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, local_stage_ref(x, ws, *biases, H), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H", [(15, 64, 4), (1, 128, 8), (20, 16, 1), (7, 32, 2)])
def test_history_stage_kernel_contract_edges(cuda_device, T, D, H):
    """Shapes the stage kernel admits beyond the model's three levels: T
    not a multiple of 5, a single token, the narrowest width (D = 16), f32,
    atol 1e-4."""
    x, ws, rpb = stage_inputs(4, 777, T, D, H, 3)
    to = lambda a: torch.from_numpy(a).to(cuda_device)
    biases = [band_rpb_bias(to(p), T, 3) for p in rpb]
    x, ws = to(x), [to(w) for w in ws]
    got = local_stage(x, ws, *biases, H)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, local_stage_ref(x, ws, *biases, H), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H", [(21, 32, 2), (20, 32, 1), (10, 48, 3), (5, 256, 16)])
def test_history_stage_rejects_shapes_outside_contract(cuda_device, T, D, H):
    """T past 20, a head dim other than 16, or D not one of 16, 32, 64, 128:
    the wrapper raises before any launch (no plain-version fallback)."""
    from rift_tpu_torch.ops import history

    x, ws, rpb = stage_inputs(5, 4, T, D, H, 3)
    to = lambda a: torch.from_numpy(a).to(cuda_device)
    biases = [band_rpb_bias(to(p), T, 3) for p in rpb]
    before = history.launches
    with pytest.raises(ValueError, match="outside the kernel's range"):
        local_stage(to(x), [to(w) for w in ws], *biases, H)
    assert history.launches == before


@pytest.mark.cuda
def test_history_stage_function_gradient_matches_plain(cuda_device):
    x, ws, biases, H = _stage_tensors(cuda_device, "level2", 64, seed=3)
    g = torch.randn(x.shape, device=cuda_device)
    grads = []
    for fn in (local_stage, local_stage_ref):
        xs = [t.clone().requires_grad_(True) for t in (x, *biases, *ws)]
        out = fn(xs[0], xs[3:], xs[1], xs[2], H)
        assert out.grad_fn is not None
        (out * g).sum().backward()
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _encoder_params(device, seed=0):
    """The HistoryEncoder's flat params from a numpy seed, RPB tables
    perturbed."""
    from rift_tpu_torch.ops.history import encoder_shapes

    r = np.random.default_rng(seed)
    W = {}
    for name, s in encoder_shapes().items():
        if name.endswith("scale"):
            a = 1.0 + 0.1 * r.normal(size=s)
        elif "rpb" in name:
            a = 0.5 * r.normal(size=s)
        elif len(s) == 1:
            a = 0.1 * r.normal(size=s)
        else:
            a = r.normal(size=s) / np.sqrt(np.prod(s[:-1]))
        W[name] = torch.from_numpy(a.astype(np.float32)).to(device)
    return W


@pytest.mark.cuda
def test_history_encoder_kernel_matches_plain(cuda_device):
    """The whole-encoder kernel at the main path's N = 1536 rows and at
    ragged N (the last block's tail masked), f32, atol 1e-4 (six f32
    LocalBlocks, the convolutions and the FPN, summed in another order)."""
    W = _encoder_params(cuda_device)
    r = np.random.default_rng(1)
    for N in (1536, 1537, 3):
        x = torch.from_numpy(r.normal(size=(N, 20, 9)).astype(np.float32)).to(cuda_device)
        got = history_encoder(x, W)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, history_encoder_ref(x, W), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="forward only"):
        history_encoder(x.requires_grad_(True), W)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8192, 5])
def test_history_encoder_kernel_chunk_edges(cuda_device, N):
    """The whole-encoder kernel at a fit step's N = 8192 history rows (a
    block walks several chunks of sequences) and at N = 5 (one block, one
    partial chunk), f32, atol 1e-4."""
    W = _encoder_params(cuda_device, seed=2)
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(size=(N, 20, 9)).astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        got = history_encoder(x, W)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, history_encoder_ref(x, W), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_history_encoder_kernel_legacy_act_rows(cuda_device):
    """The whole-encoder kernel at an act call's history rows on legacy
    (per-CBV) tokens at the bench configuration, N = 64 x 3 CBVs x 32
    agents = 6144, a quarter of them all zeros (invalid neighbour slots
    give zero differences), f32, atol 1e-4."""
    W = _encoder_params(cuda_device, seed=4)
    r = np.random.default_rng(5)
    x = r.normal(size=(6144, 20, 9)).astype(np.float32)
    x[r.random(6144) < 0.25] = 0.0
    x = torch.from_numpy(x).to(cuda_device)
    with torch.no_grad():
        got = history_encoder(x, W)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, history_encoder_ref(x, W), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_launch_counts(cuda_device):
    """Where the launches go: the HistoryEncoder takes the whole-encoder
    kernel once when no gradient flows through it and the stage kernel at
    each of its three levels when one does; an eval act at depth 1 launches
    5 attentions (the ego state, one encoder layer, three decoder
    attentions), 1 whole-encoder kernel and 1 PointNet, and no stage; on
    legacy tokens a second PointNet for the CBVs' map polygons."""
    from rift_tpu_torch.models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
    from rift_tpu_torch.models.pluto.layers import HistoryEncoder
    from rift_tpu_torch.map import make_grid_town
    from rift_tpu_torch.ops import attention, history, points
    from rift_tpu_torch.scenario import TrafficEnv, wake_all_bvs

    enc = HistoryEncoder(9, 32).to(cuda_device)
    x = torch.randn(64, 20, 9, device=cuda_device)
    count = lambda: (history.encoder_launches, history.launches)
    before = count()
    with torch.no_grad():
        enc(x)
    after = count()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    enc(x).sum().backward()
    end = count()
    assert (end[0] - after[0], end[1] - after[1]) == (0, 3)

    torch.manual_seed(0)
    tmap = make_grid_town(blocks=1, num_lanes=2, device=cuda_device)
    state, _, spec = TrafficEnv(tmap, num_scenarios=2, num_agents=8, max_cbvs=2,
                                device=cuda_device).reset()
    state = wake_all_bvs(state)
    is_cbv = state.is_cbv.clone()
    is_cbv[:, 1:3] = state.alive[:, 1:3]
    model = PlutoModel(encoder_depth=1, decoder_depth=1, device=cuda_device)
    tok = canonical_map_tokens(model, tmap)
    mods = (attention, history, points)
    start = [m.launches for m in mods] + [history.encoder_launches]
    pluto_cbv_act(model, tmap, spec, state.replace(is_cbv=is_cbv), max_cbvs=2, canonical=True,
                  map_tok=tok)
    torch.cuda.synchronize()
    done = [m.launches for m in mods] + [history.encoder_launches]
    assert [b - a for a, b in zip(start, done)] == [5, 0, 1, 1]
    pluto_cbv_act(model, tmap, spec, state.replace(is_cbv=is_cbv), max_cbvs=2)
    torch.cuda.synchronize()
    end = [m.launches for m in mods] + [history.encoder_launches]
    assert [b - a for a, b in zip(done, end)] == [5, 0, 2, 1]


@pytest.mark.cuda
def test_plant_launch_counts(cuda_device):
    """One PlanT_medium ego tick launches the attention kernel once per
    layer (8, head dim 64) and one recognition score the recognizer's 4
    (head dim 32); nothing else of the hand kernels."""
    from rift_tpu_torch.map import make_straight_town
    from rift_tpu_torch.models.plant import PlanTModel, plant_ego_waypoints
    from rift_tpu_torch.models.plant.train import plant_attn_scores
    from rift_tpu_torch.ops import attention, history, points
    from rift_tpu_torch.scenario import TrafficEnv

    tmap = make_straight_town(length=300.0, num_lanes=2, device=cuda_device)
    state, _, spec = TrafficEnv(tmap, num_scenarios=4, num_agents=20, device=cuda_device).reset()
    ego = PlanTModel(device=cuda_device).eval()
    recog = PlanTModel(dim=128, num_layers=4, num_heads=4, device=cuda_device).eval()
    mods = (attention, history, points)
    count = lambda: [m.launches for m in mods] + [history.encoder_launches]
    start = count()
    wp = plant_ego_waypoints(ego, spec, state)
    torch.cuda.synchronize()
    mid = count()
    scores = plant_attn_scores(recog, spec, state)
    torch.cuda.synchronize()
    end = count()
    assert [b - a for a, b in zip(start, mid)] == [8, 0, 0, 0]
    assert [b - a for a, b in zip(mid, end)] == [4, 0, 0, 0]
    assert torch.isfinite(wp).all() and wp.shape == (4, 30, 2)
    assert torch.isfinite(scores).any()
