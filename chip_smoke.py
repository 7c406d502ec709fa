#!/usr/bin/env python3
"""Smoke run of rift_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, and drives the Pluto CBV
planner's eval step, its train step (the GRPO evaluator) and a fine-tune
round at full width.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the four kernels from rift_tpu_torch/csrc (one nvcc each,
     started together) and print the card's name and power limit;
  2. hold each kernel against its plain version at the main path's shapes:
     attention in f32 (atol 1e-5) and bf16 (atol 2e-2), the PointNet in
     f32 (atol 1e-4), the retrack rollout (at most 1% of the 9216
     candidates diverging by more than 2e-3) and the refline matrices (at
     most 1% of the nearest points flipped, 1e-4 elsewhere); time kernel,
     plain version and, for attention, PyTorch's
     scaled_dot_product_attention (timed only; the port never calls it);
     then the gradients through the attention and PointNet autograd
     Functions against the plain versions' gradients (f32, atol 1e-4);
  3. build the grid town (blocks=2, 2 lanes per direction) and reset
     TrafficEnv at S=64 scenarios x A=24 agents x C=3 CBVs for three seeds,
     with CBVs forced on slots 1..3 and a constant-speed history;
  4. a full-width PlutoModel (encoder and decoder depth 4, bf16 compute)
     from seeded weights: canonical map tokens once, then the eval
     pluto_cbv_act on each scene, with the launch counters read around
     that run;
  5. one scene again in f32, through the kernels and through the plain
     versions on the card: the waypoints must agree within 1e-3 where the
     CBV mask holds;
  6. the train-mode pluto_cbv_act on each scene (one retrack and one
     refline launch per call besides the planner's), with the counters
     read around that run; advantages and returns finite and varying;
  7. one scene's train act in f32 through the kernels and through the
     plain versions: adv_valid identical, at most 2% of candidate returns
     off by more than 1e-2;
  8. the three scenes' samples (576) appended to a ring buffer of 512,
     then two fine-tune rounds of `fit` (2 epochs, 1 warmup, batch 256: 4
     steps each), counters read around each: finite losses, pi_head moved,
     every other parameter bit-identical.

Prints the measurements, the card line and a `kernels` JSON line before
the last line, and `{"ok": true, "device": {...}}` last. Exits non-zero
without a CUDA device or without the rift_tpu_torch package beside it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

S, A, C = 64, 24, 3
SEEDS = (0, 1, 2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet), at 700 W
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 without tensor cores
DIM, HEADS, MODES, REFS, POINTS = 128, 4, 12, 4, 120
TOKENS = 32 + 64 + 1  # agents + map polygons + static objects
HIST = ((20, 32, 2), (10, 64, 4), (5, 128, 8))  # (T, D, H) per level, 2 blocks each
EVAL_FRAMES = 40  # the GRPO evaluator's horizon


def attention_shapes():
    """(B, Tq, Tk, D, H, kind) of the attention launches of one act call at
    S x C = 192 CBVs: HistoryEncoder blocks over S*A world agents, the ego
    state encoder, the scene encoder and the decoder."""
    B, Bw = S * C, S * A
    out = []
    for T, D, H in HIST:
        out += [(Bw, T, T, D, H, "self")] * 2
    out.append((B, 1, 6, DIM, HEADS, "sep"))
    out += [(B, TOKENS, TOKENS, DIM, HEADS, "self")] * 4
    for _ in range(4):
        out += [
            (B * MODES, REFS, REFS, DIM, HEADS, "self"),
            (B * REFS, MODES, MODES, DIM, HEADS, "qk"),
            (B, REFS * MODES, TOKENS, DIM, HEADS, "sep"),
        ]
    return out


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_inputs(torch, gen, shape, dtype):
    """Inputs in the layout the model hands the kernel: self-attention q/k/v
    are slices of one packed projection, m2m's q/k of a packed pair."""
    B, Tq, Tk, D, H, kind = shape
    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    if kind == "self":
        qkv = rn(B, Tq, 3 * D)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    elif kind == "qk":
        qk = rn(B, Tq, 2 * D)
        q, k, v = qk[..., :D], qk[..., D:], rn(B, Tk, D)
    else:
        q, k, v = rn(B, Tq, D), rn(B, Tk, D), rn(B, Tk, D)
    bias = 0.5 * torch.randn(H, Tq, Tk, generator=gen, device=dev)
    pad = torch.rand(B, Tk, generator=gen, device=dev) < 0.3
    kpad = torch.where(pad, -1e9, 0.0)
    kpad[0] = -1e9  # a fully masked row
    return q, k, v, bias, kpad


def check_attention(torch, attention):
    """Kernel vs plain version at each main-path shape family, f32 and
    bf16; then times of one act call's 23 launches (bf16, as the model
    runs them)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = attention_shapes()
    err = {"float32": 0.0, "bfloat16": 0.0}
    for shape in sorted(set(shapes)):
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            args = attention_inputs(torch, gen, shape, dtype)
            got = attention.fused_attention(*args, shape[4])
            ref = attention.fused_attention_ref(*args, shape[4])
            torch.cuda.synchronize()
            e = (got.float() - ref.float()).abs().max().item()
            name = str(dtype).split(".")[-1]
            err[name] = max(err[name], e)
            if not e <= atol:
                raise AssertionError(f"attention {shape} {dtype}: max err {e} > {atol}")

    calls = [attention_inputs(torch, gen, s, torch.bfloat16) + (s[4],) for s in shapes]
    sdpa_in = []
    for q, k, v, bias, kpad, H in calls:
        B, Tq, D = q.shape
        Tk = k.shape[1]
        heads = lambda x, T: x.reshape(B, T, H, D // H).transpose(1, 2)
        mask = (bias[None] + kpad[:, None, None, :]).to(q.dtype)
        sdpa_in.append((heads(q, Tq), heads(k, Tk), heads(v, Tk), mask))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = flops = 0
    for q, k, v, bias, kpad, H in calls:
        B, Tq, D = q.shape
        Tk = k.shape[1]
        nbytes += (B * Tq * D * 2 + 2 * B * Tk * D) * q.element_size()
        nbytes += (bias.numel() + kpad.numel()) * 4
        flops += 4 * B * Tq * Tk * D
    bound, by = bound_ms(nbytes, flops, "bfloat16")
    return {
        "ms": cuda_ms(torch, lambda: [attention.fused_attention(*c) for c in calls]),
        "plain_ms": cuda_ms(torch, lambda: [attention.fused_attention_ref(*c) for c in calls]),
        "library_ms": cuda_ms(torch, lambda: [sdpa(q, k, v, attn_mask=m) for q, k, v, m in sdpa_in]),
        "bound_ms": bound,
        "bound_by": by,
        "max_abs_err": err["float32"],
        "max_abs_err_bf16": err["bfloat16"],
        "timed_work": f"the {len(calls)} launches of one act call at S={S}, bf16",
    }


def points_inputs(torch, gen, N, P, Cin, prefix_mask):
    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = 2.0 * rn(N, P, Cin)
    if prefix_mask:  # reference lines: a valid prefix per row, some empty
        n = torch.randint(0, P + 1, (N, 1), generator=gen, device=dev)
        mask = torch.arange(P, device=dev)[None] < n
        mask[5] = False
    else:
        mask = torch.ones(N, P, dtype=torch.bool, device=dev)
    w = [
        0.3 * rn(Cin, 128), 0.3 * rn(128), 0.5 + 0.3 * rn(128).abs(), 0.3 * rn(128),
        0.3 * rn(128, 256), 0.3 * rn(256),
        0.3 * rn(512, 256), 0.3 * rn(256), 0.5 + 0.3 * rn(256).abs(), 0.3 * rn(256),
        0.3 * rn(256, DIM), 0.3 * rn(DIM),
    ]
    return x, mask, w


def check_points(torch, points, num_lanes):
    """Kernel vs plain version at the reference-line shape (one launch per
    act call) and the map-token shape (once per episode); times of the
    per-call reference-line launch."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = 0.0
    for N, P, Cin, prefix in ((S * C * REFS, POINTS, 6, True), (num_lanes, 20, 10, False)):
        x, mask, w = points_inputs(torch, gen, N, P, Cin, prefix)
        got = points.points_encoder(x, mask, w, DIM)
        ref = points.points_forward_ref(x, mask, w)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        err = max(err, e)
        if not e <= 1e-4:
            raise AssertionError(f"points {(N, P, Cin)}: max err {e} > 1e-4")

    x, mask, w = points_inputs(torch, gen, S * C * REFS, POINTS, 6, True)
    N = x.shape[0]
    valid = int(mask.sum())
    per_point = 6 * 128 + 128 * 256 + 256 * 256 + 256 * DIM
    flops = 2 * valid * per_point + 2 * N * 256 * 256
    nbytes = x.numel() * 4 + mask.numel() + sum(t.numel() for t in w) * 4 + N * DIM * 4
    bound, by = bound_ms(nbytes, flops, "float32")
    return {
        "ms": cuda_ms(torch, lambda: points.points_encoder(x, mask, w, DIM)),
        "plain_ms": cuda_ms(torch, lambda: points.points_forward_ref(x, mask, w)),
        "library_ms": None,
        "bound_ms": bound,
        "bound_by": by,
        "max_abs_err": err,
        "timed_work": f"the reference-line launch of one act call, N={N}, P={POINTS}, f32",
    }


def retrack_inputs(torch, gen, G, T):
    """Candidate paths as the evaluator hands them over (path [G, T, 2],
    start heading [G], start speed [G]): world frame a few hundred meters
    from the origin, 0-20 m/s, gentle to sharp curvature, a few standing
    still (braking paths)."""
    dev = "cuda"
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    t = torch.arange(T, device=dev, dtype=torch.float32)
    step = 2.0 * u(G, 1)
    step[::17] = 0.0
    curve = 0.04 * (u(G, 1) - 0.5)
    yaw = 2 * math.pi * u(G, 1) + curve * t
    d = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1) * step[..., None]
    pos = 300.0 * u(G, 1, 2) + torch.cumsum(d, 1) - d[:, :1]
    return pos.contiguous(), yaw[:, 0].contiguous(), (12.0 * u(G)).contiguous()


def check_retrack(torch, retrack):
    """Kernel vs plain version at the train act step's shape (G = S*C*R*M
    candidates, T = 40 frames). The two sum the PID windows and the speed
    polynomials in another order, and a near-tie in the closest-point
    search or a threshold (brake ratio, throttle floor) met on one side
    only sends a candidate along another path: candidates whose center,
    heading or speed differ by more than 2e-3 anywhere (the JAX package's
    bound for its own kernel against the scan) count as diverged, and
    their share is bounded by 1%."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    G = S * C * REFS * MODES
    pos, yaw, v0 = retrack_inputs(torch, gen, G, EVAL_FRAMES)
    got = retrack.retrack_rollout(pos, yaw, v0)
    ref = retrack.retrack_rollout_ref(pos, yaw, v0)
    torch.cuda.synchronize()
    err = torch.stack([(g - r).abs().reshape(G, -1).amax(1) for g, r in zip(got, ref)])
    diverged = (err > 2e-3).any(0)
    share = diverged.float().mean().item()
    if not share <= 0.01:
        raise AssertionError(f"retrack: diverged share {share} > 0.01")
    errs = err[:, ~diverged].amax(1).tolist()  # center, heading, speed
    # bound: each input read once and each output written once; the work
    # is 39 steps of a 40-point search (5 flops a point) and ~150 flops of
    # tracker and bicycle model
    T = EVAL_FRAMES
    nbytes = 4 * (G * T * 2 + 2 * G + G * T * 4)  # path, start heading and speed; outputs
    flops = G * (T - 1) * (5 * T + 150)
    bound, by = bound_ms(nbytes, flops, "float32")
    return {
        "ms": cuda_ms(torch, lambda: retrack.retrack_rollout(pos, yaw, v0)),
        "plain_ms": cuda_ms(torch, lambda: retrack.retrack_rollout_ref(pos, yaw, v0), iters=3),
        "library_ms": None,
        "bound_ms": bound,
        "bound_by": by,
        "max_abs_err": max(errs),
        "max_abs_err_center_heading_speed": errs,
        "diverged_share": share,
        "diverged_max_err": err.max().item(),
        "timed_work": f"one launch, G={G} candidates, T={T}, f32",
    }


def refline_inputs(torch, gen, BR, MT, Nr):
    """Local-frame candidate points (0-80 m ahead, +-10 m aside) and
    reference lines of Nr points 1 m apart with a valid prefix; every 11th
    line is empty, as padded lines are."""
    dev = "cuda"
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    cand = torch.stack([80.0 * u(BR, MT), 20.0 * (u(BR, MT) - 0.5)], -1)
    cand_h = math.pi * (u(BR, MT) - 0.5)
    h = 0.5 * (u(BR, 1) - 0.5) + 0.01 * (u(BR, 1) - 0.5) * torch.arange(Nr, device=dev)
    step = torch.stack([torch.cos(h), torch.sin(h)], -1)
    ref = torch.cumsum(step, 1) - step[:, :1] + 5.0 * (u(BR, 1, 2) - 0.5)
    n = torch.randint(1, Nr + 1, (BR, 1), generator=gen, device=dev)
    valid = torch.arange(Nr, device=dev) < n
    valid[::11] = False
    return cand.contiguous(), cand_h.contiguous(), ref.contiguous(), h.contiguous(), valid


def check_refline(torch, refline):
    """Kernel vs plain version at the train act step's shape (BR = S*C*R
    pairs, MT = M*40 points, Nr = 120). The plain version's distance
    expansion rounds differently from the kernel's direct differences, so
    the nearest point may flip where two are almost equally far: the share
    of flipped points is bounded, and where the index agrees the outputs
    agree within 1e-4."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    BR, MT = S * C * REFS, MODES * EVAL_FRAMES
    args = refline_inputs(torch, gen, BR, MT, POINTS)
    dis, ang, idx = refline.refline_matrices(*args, return_index=True)
    rdis, rang, ridx = refline.refline_matrices_ref(*args, return_index=True)
    torch.cuda.synchronize()
    same = idx == ridx
    flips = 1.0 - same.float().mean().item()
    err = max((dis - rdis)[same].abs().max().item(), (ang - rang)[same].abs().max().item())
    if not flips <= 0.01 or not err <= 1e-4:
        raise AssertionError(f"refline: flipped share {flips}, error {err}")
    valid_pts = int(args[4].sum())
    nbytes = 4 * (BR * MT * 3 + BR * POINTS * 3 + 2 * BR * MT) + BR * POINTS
    flops = 5 * MT * valid_pts  # the search over this run's valid points
    bound, by = bound_ms(nbytes, flops, "float32")
    return {
        "ms": cuda_ms(torch, lambda: refline.refline_matrices(*args)),
        "plain_ms": cuda_ms(torch, lambda: refline.refline_matrices_ref(*args)),
        "library_ms": None,
        "bound_ms": bound,
        "bound_by": by,
        "max_abs_err": err,
        "flipped_share": flips,
        "timed_work": f"one launch, BR={BR} pairs, MT={MT}, Nr={POINTS}, f32",
    }


def make_scene(torch, tmap, seed):
    """Reset S scenarios, force CBVs on slots 1..C (recognition needs a
    warm-up the world tick provides; it comes with the next slice) and give
    every live agent a 2 s constant-speed history along its heading."""
    from rift_tpu_torch.scenario import TrafficEnv, wake_all_bvs

    env = TrafficEnv(
        tmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=seed, device=tmap.device
    )
    state, spec = env.reset()
    state = wake_all_bvs(state)
    cbv = torch.zeros_like(state.is_cbv)
    cbv[:, 1:C + 1] = state.alive[:, 1:C + 1]
    goal = state.goal.clone()
    dev = state.pos.device
    goal[:, 1:C + 1] = state.pos[:, 1:C + 1] + torch.tensor([60.0, 0.0], device=dev)
    H = state.hist_valid.shape[-1]
    speed = torch.where(state.alive, 8.0, 0.0)
    direction = torch.stack([torch.cos(state.heading), torch.sin(state.heading)], -1)
    vel = speed[..., None] * direction
    back = 0.1 * torch.arange(H - 1, -1, -1, device=dev, dtype=torch.float32)
    state = state.replace(
        is_cbv=cbv,
        goal=goal,
        goal_valid=state.goal_valid | cbv,
        speed=speed,
        hist_pos=state.pos[:, :, None] - back[:, None] * vel[:, :, None],
        hist_heading=state.heading[..., None].expand(-1, -1, H).clone(),
        hist_vel=vel[:, :, None].expand(-1, -1, H, -1).clone(),
        hist_valid=state.alive[..., None].expand(-1, -1, H).clone(),
    )
    return state, spec


def check_gradients(torch, attention, points):
    """The autograd Functions around the kernels: gradients through the
    kernels equal the plain versions' gradients (both backwards recompute
    through the plain version) at one HistoryEncoder attention shape and
    one per-sample map PointNet shape, f32."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    err = {}
    B, T, D, H = S * A, 20, 32, 2  # the first HistoryEncoder level
    args = attention_inputs(torch, gen, (B, T, T, D, H, "sep"), torch.float32)
    w = torch.randn(B, T, D, generator=gen, device="cuda")
    x, mask, pw = points_inputs(torch, gen, 256 * 64, 20, 10, False)
    g = torch.randn(x.shape[0], DIM, generator=gen, device="cuda")
    cases = {
        "fused_attention": (
            lambda xs: attention.fused_attention(*xs, args[4], H),
            lambda xs: attention.fused_attention_ref(*xs, args[4], H), args[:4], w),
        "points_encoder": (
            lambda xs: points.points_encoder(xs[0], mask, xs[1:], DIM),
            lambda xs: points.points_forward_ref(xs[0], mask, xs[1:]), [x, *pw], g),
    }
    for name, (kernel, plain, inputs, weight) in cases.items():
        grads = []
        for fn in (kernel, plain):
            xs = [t.clone().requires_grad_(True) for t in inputs]
            out = fn(xs)
            if out.grad_fn is None:
                raise AssertionError(f"{name}: no grad_fn on the output")
            (out * weight).sum().backward()
            grads.append([t.grad for t in xs])
        torch.cuda.synchronize()
        err[name] = max((a - b).abs().max().item() for a, b in zip(*grads))
        if not err[name] <= 1e-4:
            raise AssertionError(f"{name}: gradients differ by {err[name]}")
    return err


def read_launches(kernel_modules):
    return {name: mod.launches for name, mod in kernel_modules.items()}


def zero_launches(kernel_modules):
    for mod in kernel_modules.values():
        mod.launches = 0


def time_calls(torch, fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t1) * 1e3 / reps


def train_samples(torch, out):
    """One train act call's buffer samples, flattened to [S*C], and which
    of them are real (the runner's `_store_chunk`)."""
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    feats = {g: {k: flat(v) for k, v in d.items()} if isinstance(d, dict) else flat(d)
             for g, d in out["features"].items()}
    samples = {
        "features": feats,
        "old_logits": flat(out["old_logits"]),
        "advantage": flat(out["advantage"]),
        "valid": flat(out["adv_valid"]),
    }
    return samples, flat(out["cbv_slots"] >= 0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import rift_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: rift_tpu_torch not found ({e})", file=sys.stderr)
        return 2
    from rift_tpu_torch.map import make_grid_town
    from rift_tpu_torch.models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
    from rift_tpu_torch.models.pluto import layers
    from rift_tpu_torch.ops import attention, build, points, refline, retrack
    from rift_tpu_torch.rl import TrainConfig, fit, rift_loss_fn, ring_append, ring_init
    from rift_tpu_torch.rl import evaluator

    kernel_modules = {
        "fused_attention": attention, "points_encoder": points,
        "retrack_rollout": retrack, "refline_matrices": refline,
    }
    t0 = time.perf_counter()
    # ---- phase 1: build
    logs = build.build_all(["attention", "points", "retrack", "refline"])
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# {name}: {line.strip()}", file=sys.stderr)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"# build {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 2: kernels against their plain versions (the map's lane
    # count sizes the map-token check), and the gradients through them
    tmap = make_grid_town(blocks=2, num_lanes=2)
    results = {
        "fused_attention": check_attention(torch, attention),
        "points_encoder": check_points(torch, points, tmap.num_lanes),
        "retrack_rollout": check_retrack(torch, retrack),
        "refline_matrices": check_refline(torch, refline),
    }
    grad_err = check_gradients(torch, attention, points)
    print(f"# map L={tmap.num_lanes}, kernels checked {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # ---- phase 3: scenes
    scenes = [make_scene(torch, tmap, seed) for seed in SEEDS]
    print(f"# scenes {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 4: the eval act step at full width
    torch.manual_seed(0)
    model = PlutoModel(encoder_depth=4, decoder_depth=4).eval()
    zero_launches(kernel_modules)
    map_tok = canonical_map_tokens(model, tmap)
    outs = [
        pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, map_tok=map_tok)
        for state, spec in scenes
    ]
    torch.cuda.synchronize()
    eval_launches = read_launches(kernel_modules)
    want = {
        "fused_attention": len(attention_shapes()) * len(scenes),
        "points_encoder": 1 + len(scenes),
        "retrack_rollout": 0, "refline_matrices": 0,
    }
    if eval_launches != want:
        raise AssertionError(f"eval-path launches {eval_launches}, expected {want}")
    for out in outs:
        valid = int((out["cbv_slots"] >= 0).sum())
        if valid != S * C:
            raise AssertionError(f"{valid} valid CBV slots, expected {S * C}")
        if not torch.isfinite(out["traj"]).all() or int(out["mask"].sum()) != S * C:
            raise AssertionError("non-finite waypoints or a wrong CBV mask")
    state, spec = scenes[0]
    act_ms = time_calls(
        torch, lambda: pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, map_tok=map_tok),
        10, warmup=2,
    )
    print(f"# eval path done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 5: f32 eval act through the kernels vs the plain versions
    model32 = PlutoModel(encoder_depth=4, decoder_depth=4, dtype=torch.float32).eval()
    model32.load_state_dict(model.state_dict())
    tok32 = canonical_map_tokens(model32, tmap)
    kernel_fns = (layers.fused_attention, layers.points_encoder,
                  evaluator.refline_matrices, evaluator.retrack_rollout)

    def plain_versions():
        layers.fused_attention = attention.fused_attention_ref
        layers.points_encoder = (
            lambda x, m, w, out_dim, has_ln=True: points.points_forward_ref(x, m, w, has_ln)
        )
        evaluator.refline_matrices = refline.refline_matrices_ref
        evaluator.retrack_rollout = retrack.retrack_rollout_ref

    def kernel_versions():
        (layers.fused_attention, layers.points_encoder,
         evaluator.refline_matrices, evaluator.retrack_rollout) = kernel_fns

    got = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, map_tok=tok32)
    plain_versions()
    try:
        ref = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C,
                            map_tok=canonical_map_tokens(model32, tmap))
    finally:
        kernel_versions()
    torch.cuda.synchronize()
    mask = ref["mask"]
    if not torch.equal(got["mask"], mask):
        raise AssertionError("f32 CBV masks differ between kernels and plain versions")
    traj_err = (got["traj"][mask] - ref["traj"][mask]).abs().max().item()
    if not traj_err <= 1e-3:
        raise AssertionError(f"f32 waypoints differ by {traj_err} > 1e-3")

    # ---- phase 6: the train act step at full width (the GRPO evaluator
    # through the retrack and refline kernels)
    zero_launches(kernel_modules)
    train_outs = [
        pluto_cbv_act(model, tmap, spec_, state_, max_cbvs=C, train=True, map_tok=map_tok)
        for state_, spec_ in scenes
    ]
    torch.cuda.synchronize()
    train_launches = read_launches(kernel_modules)
    want = {
        "fused_attention": len(attention_shapes()) * len(scenes),
        "points_encoder": len(scenes),
        "retrack_rollout": len(scenes), "refline_matrices": len(scenes),
    }
    if train_launches != want:
        raise AssertionError(f"train-act launches {train_launches}, expected {want}")
    for out in train_outs:
        valid = out["adv_valid"]
        n_valid = int(valid.sum())
        adv, ret = out["advantage"][valid], out["rollout_return"][valid]
        if n_valid < S * C * MODES or not (torch.isfinite(adv).all() and torch.isfinite(ret).all()):
            raise AssertionError(f"train act: {n_valid} valid candidates or non-finite values")
        if not (adv.std().item() > 0.5 and ret.std().item() > 0.1):
            raise AssertionError("train act: advantages or returns do not vary")
    train_ms = time_calls(
        torch, lambda: pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, train=True,
                                     map_tok=map_tok), 5, warmup=2,
    )
    print(f"# train act done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 7: f32 train act through the kernels vs the plain versions.
    # The re-tracking is chaotic at near-ties (a closest point or a brake
    # threshold met on one side only), and collision and off-road flags are
    # discrete, so a flipped candidate's return moves by up to ~20: the
    # share of candidates off by more than 1e-2 is bounded, not forbidden.
    got = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, train=True, map_tok=tok32)
    plain_versions()
    try:
        ref = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, train=True,
                            map_tok=canonical_map_tokens(model32, tmap))
    finally:
        kernel_versions()
    torch.cuda.synchronize()
    if not torch.equal(got["adv_valid"], ref["adv_valid"]):
        raise AssertionError("f32 train act: adv_valid differs between kernels and plain")
    v = ref["adv_valid"]
    ret_err = (got["rollout_return"] - ref["rollout_return"])[v].abs()
    off_share = (ret_err > 1e-2).float().mean().item()
    if not off_share <= 0.02:
        raise AssertionError(f"f32 train act: {off_share} of returns off by > 1e-2")

    # ---- phase 8: fit on a full buffer of the train samples
    samples = [train_samples(torch, out) for out in train_outs]
    first = lambda t: {k: first(x) for k, x in t.items()} if isinstance(t, dict) else t[0]
    buf = ring_init(first(samples[0][0]), capacity=512)
    for smp, valid in samples:
        ring_append(buf, smp, valid)
    if not buf.full:
        raise AssertionError(f"buffer holds {buf.size} of {buf.capacity}")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = TrainConfig(epochs=2, warmup_epochs=1)
    steps = cfg.epochs * (buf.size // cfg.batch_size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fit_ms, losses = [], []
    # two rounds: the first carries the backward's one-time CUDA set-up
    for round_idx in range(2):
        zero_launches(kernel_modules)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses += fit(model, buf, rift_loss_fn, cfg, gen, round_idx=round_idx)
        torch.cuda.synchronize()
        fit_ms.append((time.perf_counter() - t1) * 1e3 / steps)
        fit_launches = read_launches(kernel_modules)
        # per forward: 23 attentions; the per-sample map rows and the ref lines
        want = {"fused_attention": 23 * steps, "points_encoder": 2 * steps,
                "retrack_rollout": 0, "refline_matrices": 0}
        if fit_launches != want:
            raise AssertionError(f"fit launches {fit_launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fit losses {losses}")
    moved, changed = 0.0, []
    for n, p in model.named_parameters():
        d = (p.detach() - before[n]).abs().sum().item()
        if n.startswith("planning_decoder.pi_head"):
            moved += d
        elif not torch.equal(p.detach(), before[n]):
            changed.append(n)
    if not moved > 0.0 or changed:
        raise AssertionError(f"fit moved pi_head by {moved}; other params changed: {changed}")
    print(f"# fit done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    kernels = []
    sources = {
        "fused_attention": ("rift_tpu_torch/csrc/attention.cu", "rift_tpu/ops/attention.py:78"),
        "points_encoder": ("rift_tpu_torch/csrc/points.cu", "rift_tpu/ops/points.py:116"),
        "retrack_rollout": ("rift_tpu_torch/csrc/retrack.cu", "rift_tpu/ops/retrack.py:234"),
        "refline_matrices": ("rift_tpu_torch/csrc/refline.cu", "rift_tpu/ops/refline.py:88"),
    }
    for name, r in results.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": train_launches[name],
            "launches_by_path": {"eval_act": eval_launches[name],
                                 "train_act": train_launches[name], "fit": fit_launches[name]},
            **r,
        })
    print(json.dumps({
        "act_step": {
            "ms_per_call": act_ms, "scenarios": S, "agents": A, "cbvs": C,
            "dtype": "bfloat16", "f32_traj_max_abs_err": traj_err,
        },
        "train_act_step": {
            "ms_per_call": train_ms, "candidates": S * C * REFS * MODES,
            "f32_return_off_share": off_share,
            "f32_return_max_abs_err": ret_err.max().item(),
            "f32_return_median_abs_err": ret_err.median().item(),
        },
        "fit": {
            "ms_per_step": fit_ms[1], "ms_per_step_first_round": fit_ms[0],
            "steps_per_round": steps, "batch": cfg.batch_size,
            "buffer": buf.size, "epoch_losses": losses, "pi_head_abs_delta": moved,
        },
        "gradient_max_abs_err": grad_err,
        "seconds_total": time.perf_counter() - t0,
    }))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
