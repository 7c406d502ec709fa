#!/usr/bin/env python3
"""Smoke run of rift_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, and drives the Pluto CBV
planner's eval step at full width.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build both kernels from rift_tpu_torch/csrc (one nvcc each, started
     together) and print the card's name and power limit;
  2. hold each kernel against its plain version at the main path's shapes:
     attention in f32 (atol 1e-5) and bf16 (atol 2e-2), the PointNet in
     f32 (atol 1e-4); time kernel, plain version and, for attention,
     PyTorch's scaled_dot_product_attention (timed only; the port never
     calls it);
  3. build the grid town (blocks=2, 2 lanes per direction) and reset
     TrafficEnv at S=64 scenarios x A=24 agents x C=3 CBVs for three seeds,
     with CBVs forced on slots 1..3 and a constant-speed history;
  4. a full-width PlutoModel (encoder and decoder depth 4, bf16 compute)
     from seeded weights: canonical map tokens once, then pluto_cbv_act on
     each scene, with the kernels' launch counters read around that run;
  5. one scene again in f32, through the kernels and through the plain
     versions on the card: the waypoints must agree within 1e-3 where the
     CBV mask holds.

Prints the card line and a `kernels` JSON line before the last line, and
`{"ok": true, "device": {...}}` last. Exits non-zero without a CUDA device
or without the rift_tpu_torch package beside it.
"""

from __future__ import annotations

import json
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
    from rift_tpu_torch.ops import attention, build, points

    t0 = time.perf_counter()
    # ---- phase 1: build
    logs = build.build_all(["attention", "points"])
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
    # count sizes the map-token check)
    tmap = make_grid_town(blocks=2, num_lanes=2)
    results = {
        "fused_attention": check_attention(torch, attention),
        "points_encoder": check_points(torch, points, tmap.num_lanes),
    }
    print(f"# map L={tmap.num_lanes}, kernels checked {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # ---- phase 3: scenes
    scenes = [make_scene(torch, tmap, seed) for seed in SEEDS]
    print(f"# scenes {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 4: the main path at full width
    torch.manual_seed(0)
    model = PlutoModel(encoder_depth=4, decoder_depth=4).eval()
    attention.launches = points.launches = 0
    map_tok = canonical_map_tokens(model, tmap)
    outs = [
        pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, map_tok=map_tok)
        for state, spec in scenes
    ]
    torch.cuda.synchronize()
    launches = {"fused_attention": attention.launches, "points_encoder": points.launches}
    want = {
        "fused_attention": len(attention_shapes()) * len(scenes),
        "points_encoder": 1 + len(scenes),
    }
    if launches != want:
        raise AssertionError(f"main-path launches {launches}, expected {want}")
    for out in outs:
        valid = int((out["cbv_slots"] >= 0).sum())
        if valid != S * C:
            raise AssertionError(f"{valid} valid CBV slots, expected {S * C}")
        if not torch.isfinite(out["traj"]).all() or int(out["mask"].sum()) != S * C:
            raise AssertionError("non-finite waypoints or a wrong CBV mask")
    state, spec = scenes[0]
    act = lambda: pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, map_tok=map_tok)
    for _ in range(2):
        act()
    torch.cuda.synchronize()
    reps = 10
    t1 = time.perf_counter()
    for _ in range(reps):
        act()
    torch.cuda.synchronize()
    act_ms = (time.perf_counter() - t1) * 1e3 / reps
    print(f"# main path done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 5: f32 through the kernels vs the plain versions
    model32 = PlutoModel(encoder_depth=4, decoder_depth=4, dtype=torch.float32).eval()
    model32.load_state_dict(model.state_dict())
    tok32 = canonical_map_tokens(model32, tmap)
    got = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, map_tok=tok32)
    kernel_fns = (layers.fused_attention, layers.points_encoder)
    layers.fused_attention = attention.fused_attention_ref
    layers.points_encoder = lambda x, m, w, out_dim, has_ln=True: points.points_forward_ref(x, m, w, has_ln)
    try:
        ref = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C,
                            map_tok=canonical_map_tokens(model32, tmap))
    finally:
        layers.fused_attention, layers.points_encoder = kernel_fns
    torch.cuda.synchronize()
    mask = ref["mask"]
    if not torch.equal(got["mask"], mask):
        raise AssertionError("f32 CBV masks differ between kernels and plain versions")
    traj_err = (got["traj"][mask] - ref["traj"][mask]).abs().max().item()
    if not traj_err <= 1e-3:
        raise AssertionError(f"f32 waypoints differ by {traj_err} > 1e-3")

    kernels = []
    sources = {
        "fused_attention": ("rift_tpu_torch/csrc/attention.cu", "rift_tpu/ops/attention.py:78"),
        "points_encoder": ("rift_tpu_torch/csrc/points.cu", "rift_tpu/ops/points.py:116"),
    }
    for name, r in results.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], **r,
        })
    print(json.dumps({
        "act_step": {
            "ms_per_call": act_ms, "scenarios": S, "agents": A, "cbvs": C,
            "dtype": "bfloat16", "f32_traj_max_abs_err": traj_err,
            "seconds_total": time.perf_counter() - t0,
        }
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
