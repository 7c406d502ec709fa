#!/usr/bin/env python3
"""Times the attention, PointNet, whole-HistoryEncoder, re-tracking and
reference-line CUDA kernels of two checkouts of this repository on one
card, in turns: baseline, this tree, this tree, baseline.

    git archive HEAD~1 | (mkdir -p build/baseline && tar -x -C build/baseline)
    python3 tools/kernel_ab.py --baseline build/baseline

Each turn is a fresh process whose `rift_tpu_torch` is the checkout's own
(PYTHONPATH), so each builds and launches its own kernels behind the same
Python entry points (`fused_attention`, `points_encoder`,
`history_encoder`). The inputs are made on the card from fixed seeds, the
same in every turn: the attention at the 17 launches of one planner
forward in bf16 (chip_smoke.py's `attention_shapes` and
`attention_inputs`, read from this tree for both turns) at the act's 192
CBVs, a fit step's batch 256, and 12 and 48 CBVs (4 and 16 scenarios of
3 CBVs), launched from Python (`ms`) and replayed from a CUDA graph
(`device_ms`, also per launch shape), with a digest of the outputs of the
17 in bf16 and in f32, and the act's 17 timed in f32 too; PlanT's
launches in f32 at 64 scenarios (one ego tick's 8 at head dim 64, which
a tree whose kernel stops at 32 refuses, and one recognition tick's 4);
the PointNet at
the act's reference-line launch (N=768 rows of P=120 points, C=6, a random
valid prefix per row) and at the fit's map-row launch (N=16384, P=20, C=10,
every point valid); the whole encoder at the act's N=1536 and the fit's
N=8192 history rows, with a SHA-256 digest of its outputs; the
HistoryEncoder stage's three launches (one per level, chip_smoke.py's
`stage_inputs`) at N=1536 and 8192 rows, with a digest of their outputs
and their error against the plain version (in a tree whose wrapper has
`stage_chunk`, also each launch with chunks of 4, 8 and its own number
of sequences: `ms_by_level_and_chunk`); the GRPO evaluator's re-tracking at the train act's
G=9216 candidates of T=40 points and its reference-line matrices at
BR=768 pairs, MT=480, Nr=120 (chip_smoke.py's `retrack_inputs` and
`refline_inputs`), launched from Python (`ms`) and replayed from a CUDA
graph (`device_ms`), each with a digest of its outputs. The digests show
whether two versions of a kernel give the same bits (the summary's
`same_bits`). Each
turn also checks the other kernels against the plain versions (max abs
error, f32), and times on the host clock (ending in a synchronise) the
eval act step, the train act step and a fine-tune step at batch 256 as
`python3 -m rift_tpu_torch.profile_act --mode eval|train|fit` sets them
up (chip_smoke's scene at S=64, the full-width bf16 model), without the
profiler. Prints one JSON line per turn and a summary line with each
number per turn, the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

DIM = 128
ATTENTION_BATCH = {"attention_act": 192, "attention_fit": 256, "attention_12": 12,
                   "attention_48": 48}
# PlanT's launches at S = 64 scenarios, f32: one ego tick's 8 (head dim 64;
# a tree whose kernel stops at head dim 32 records its refusal) and one
# recognition tick's 4
PLANT_ATTENTION = {"attention_plant_ego": ("plant_ego", 8),
                   "attention_plant_recog": ("plant_recog", 4)}
POINT_SHAPES = {"points_act": (768, 120, 6, True), "points_fit": (16384, 20, 10, False)}
ENCODER_SHAPES = {"encoder_act": 1536, "encoder_fit": 8192}
STAGE_SHAPES = {"stage_act": 1536, "stage_fit": 8192}
EVALUATOR = ("retrack", "refline")


def _chip_smoke():
    """This tree's chip_smoke.py, loaded by path: the one home of the
    attention shapes and of the timers. (sys.path is left alone, so that
    `rift_tpu_torch` stays the turn's own checkout.)"""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _chip_smoke()
cuda_ms, graph_ms = smoke.cuda_ms, smoke.graph_ms


def attention_calls(torch, seed, B, dtype=None):
    """The 17 attention launches of one planner forward at batch B, bf16
    unless `dtype` says otherwise: (q, k, v, bias, kpad, heads) each."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [smoke.attention_inputs(torch, gen, s, dtype or torch.bfloat16) + (s[4],)
            for s in smoke.attention_shapes(B)]


def attention_case(torch, attention, calls, digest_calls=()):
    """ms (launched from Python), device_ms (replayed from a CUDA graph,
    also per launch shape), the largest error against the plain version,
    and a digest of the outputs of `calls` and `digest_calls`."""
    err = max((attention.fused_attention(*c).float()
               - attention.fused_attention_ref(*c).float()).abs().max().item()
              for c in calls)
    kernel = lambda: [attention.fused_attention(*c) for c in calls]
    by_launch = {}
    for c in calls:
        key = "x".join(map(str, (c[0].shape[0], c[0].shape[1], c[1].shape[1])))
        if key not in by_launch:
            by_launch[key] = graph_ms(torch, lambda: attention.fused_attention(*c))
    return {"ms": cuda_ms(torch, kernel), "device_ms": graph_ms(torch, kernel),
            "device_ms_by_launch": by_launch, "max_abs_err": err,
            "digest": digest(*(attention.fused_attention(*c) for c in (*calls, *digest_calls)))}


def points_inputs(torch, seed, N, P, C, prefix):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = 2.0 * rn(N, P, C)
    if prefix:
        n = torch.randint(0, P + 1, (N, 1), generator=gen, device="cuda")
        mask = torch.arange(P, device="cuda")[None] < n
    else:
        mask = torch.ones(N, P, dtype=torch.bool, device="cuda")
    w = [
        0.3 * rn(C, 128), 0.3 * rn(128), 0.5 + 0.3 * rn(128).abs(), 0.3 * rn(128),
        0.3 * rn(128, 256), 0.3 * rn(256),
        0.3 * rn(512, 256), 0.3 * rn(256), 0.5 + 0.3 * rn(256).abs(), 0.3 * rn(256),
        0.3 * rn(256, DIM), 0.3 * rn(DIM),
    ]
    return x, mask, w


def encoder_inputs(torch, seed, N):
    from rift_tpu_torch.ops.history import encoder_shapes

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    W = {}
    for name, shape in encoder_shapes().items():
        if name.endswith("scale"):
            W[name] = 1.0 + 0.1 * rn(*shape)
        elif "rpb" in name:
            W[name] = 0.5 * rn(*shape)
        elif len(shape) == 1:
            W[name] = 0.1 * rn(*shape)
        else:
            W[name] = rn(*shape) / math.sqrt(math.prod(shape[:-1]))
    return rn(N, 20, 9), W


def stage_calls(torch, seed, N):
    """The HistoryEncoder stage's three launches (one per level) at N
    history rows, on chip_smoke's `stage_inputs`: (x, weights, biases, H)
    each."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(*smoke.stage_inputs(torch, gen, N, T, D, H, w), H)
            for (T, D, H), w in zip(smoke.HIST, smoke.WINDOWS)]


def stage_chunk_sweep(torch, history, calls) -> dict:
    """ms of each stage launch with chunks of 4, 8 and the wrapper's own
    number of sequences (`stage_chunk`, patched for the sweep), keyed
    "T=..,G=..", with the largest error against the plain version."""
    chosen = history.stage_chunk
    out = {}
    try:
        for x, w, b, H in calls:
            T, D = x.shape[1:]
            for G in sorted({4, 8, chosen(T, D)}):
                history.stage_chunk = lambda T, D, G=G: G
                err = (history.local_stage(x, w, *b, H)
                       - history.local_stage_ref(x, w, *b, H)).abs().max().item()
                out[f"T={T},G={G}"] = {
                    "ms": cuda_ms(torch, lambda: history.local_stage(x, w, *b, H)),
                    "max_abs_err": err}
    finally:
        history.stage_chunk = chosen
    return out


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes (any dtype)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def evaluator_kernels(torch) -> dict:
    """The re-tracking and reference-line kernels at the train act's
    shapes, on chip_smoke's inputs (the same seeds as its checks)."""
    from rift_tpu_torch.ops import refline, retrack

    gen = torch.Generator(device="cuda").manual_seed(2)
    rt = smoke.retrack_inputs(torch, gen, smoke.S * smoke.C * smoke.REFS * smoke.MODES,
                              smoke.EVAL_FRAMES)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rl = smoke.refline_inputs(torch, gen, smoke.S * smoke.C * smoke.REFS,
                              smoke.MODES * smoke.EVAL_FRAMES, smoke.POINTS)
    out = {}
    for name, fn, full in (
        ("retrack", lambda: retrack.retrack_rollout(*rt), lambda: retrack.retrack_rollout(*rt)),
        ("refline", lambda: refline.refline_matrices(*rl),
         lambda: refline.refline_matrices(*rl, return_index=True)),
    ):
        out[name] = {"ms": cuda_ms(torch, fn), "device_ms": graph_ms(torch, fn),
                     "digest": digest(*full())}
    return out


def host_ms(torch, fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def step_times(torch) -> dict:
    """Host ms per eval act call and per fine-tune step (batch 256,
    pi_head trained), as profile_act sets them up."""
    import chip_smoke as cs
    from rift_tpu_torch.map import make_grid_town
    from rift_tpu_torch.models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
    from rift_tpu_torch.rl import TrainConfig, gather_batch, make_optimizer, rift_loss_fn
    from rift_tpu_torch.rl import ring_append, ring_init, train_step

    tmap = make_grid_town(blocks=2, num_lanes=2)
    state, spec = cs.make_scene(torch, tmap, 0)
    torch.manual_seed(0)
    model = PlutoModel(encoder_depth=4, decoder_depth=4).eval()
    tok = canonical_map_tokens(model, tmap)
    # canonical tokens in every tree (a tree without the flag has no other)
    canon = {"canonical": True} if "canonical" in inspect.signature(pluto_cbv_act).parameters else {}
    act = lambda train: pluto_cbv_act(model, tmap, spec, state, max_cbvs=cs.C, train=train,
                                      map_tok=tok, **canon)
    act_ms = host_ms(torch, lambda: act(False), 10)
    train_ms = host_ms(torch, lambda: act(True), 5)
    samples, valid = cs.train_samples(torch, act(True))
    first = lambda t: {k: first(x) for k, x in t.items()} if isinstance(t, dict) else t[0]
    buf = ring_append(ring_init(first(samples), capacity=256), samples, valid)
    cfg = TrainConfig()
    batch = gather_batch(buf, torch.arange(cfg.batch_size, device="cuda") % buf.size)
    opt = make_optimizer(model, cfg)
    for n, p in model.named_parameters():  # frozen, as fit() holds them
        p.requires_grad_("pi_head" in n)
    fit_ms = host_ms(torch, lambda: train_step(model, opt, rift_loss_fn, batch, cfg.lr, cfg), 20)
    return {"eval_act_step": {"ms": act_ms}, "train_act_step": {"ms": train_ms},
            "fit_step": {"ms": fit_ms}}


def turn() -> dict:
    """Time and check this process's kernels, then the steps."""
    import torch
    import rift_tpu_torch
    from rift_tpu_torch.ops import attention, history, points

    out = {"package": str(Path(rift_tpu_torch.__file__).resolve().parent.parent)}
    for name, B in ATTENTION_BATCH.items():
        # timed in bf16, as the planner runs; the digest also covers f32
        out[name] = attention_case(torch, attention, attention_calls(torch, 0, B),
                                   attention_calls(torch, 0, B, torch.float32))
    out["attention_act_f32"] = attention_case(torch, attention,
                                              attention_calls(torch, 0, 192, torch.float32))
    for name, (shape, layers) in PLANT_ATTENTION.items():
        gen = torch.Generator(device="cuda").manual_seed(4)
        s = smoke.plant_attention_shapes(64)[shape]
        calls = [smoke.attention_inputs(torch, gen, s, torch.float32) + (s[4],)
                 for _ in range(layers)]
        try:
            out[name] = attention_case(torch, attention, calls)
        except ValueError as e:  # beyond the kernel's head dim in that tree
            out[name] = {"ms": None, "refused": str(e)}
    for name, (N, P, C, prefix) in POINT_SHAPES.items():
        x, mask, w = points_inputs(torch, 1, N, P, C, prefix)
        got = points.points_encoder(x, mask, w, DIM)
        err = (got - points.points_forward_ref(x, mask, w)).abs().max().item()
        ms = cuda_ms(torch, lambda: points.points_encoder(x, mask, w, DIM))
        out[name] = {"ms": ms, "max_abs_err": err, "valid_points": int(mask.sum())}
    with torch.no_grad():
        for name, N in ENCODER_SHAPES.items():
            x, W = encoder_inputs(torch, 6, N)
            got = history.history_encoder(x, W)
            err = (got - history.history_encoder_ref(x, W)).abs().max().item()
            ms = cuda_ms(torch, lambda: history.history_encoder(x, W))
            out[name] = {"ms": ms, "max_abs_err": err, "digest": digest(got)}
        for name, N in STAGE_SHAPES.items():
            calls = stage_calls(torch, 5, N)
            got = [history.local_stage(x, w, *b, H) for x, w, b, H in calls]
            err = max((g - history.local_stage_ref(x, w, *b, H)).abs().max().item()
                      for g, (x, w, b, H) in zip(got, calls))
            ms = cuda_ms(torch, lambda: [history.local_stage(x, w, *b, H) for x, w, b, H in calls])
            out[name] = {"ms": ms, "max_abs_err": err, "digest": digest(*got)}
            if hasattr(history, "stage_chunk"):
                out[name]["ms_by_level_and_chunk"] = stage_chunk_sweep(torch, history, calls)
    out.update(evaluator_kernels(torch))
    out.update(step_times(torch))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="directory of the other checkout")
    ap.add_argument("--turn", action="store_true", help="time this process's kernels only")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.turn:
        print(json.dumps(turn()))
        return 0
    if not args.baseline:
        ap.error("--baseline is required")
    here = Path(__file__).resolve().parent.parent
    base = Path(args.baseline).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    turns = []
    for label, tree in (("baseline", base), ("this", here), ("this", here), ("baseline", base)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        env.pop("RIFT_TORCH_KERNEL_DIR", None)
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--turn"],
            cwd=tree, env=env, capture_output=True, text=True, timeout=600,
        )
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            raise RuntimeError(f"turn {label} in {tree} failed")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        r["label"] = label
        print(json.dumps(r))
        turns.append(r)
    summary = {"card": card}
    for name in (*ATTENTION_BATCH, "attention_act_f32", *PLANT_ATTENTION, *POINT_SHAPES,
                 *ENCODER_SHAPES, *STAGE_SHAPES, *EVALUATOR, "eval_act_step", "train_act_step",
                 "fit_step"):
        summary[name] = {"ms_by_turn": [(t["label"], t[name]["ms"]) for t in turns]}
        for key in ("device_ms", "device_ms_by_launch", "digest", "ms_by_level_and_chunk",
                    "refused"):
            if any(key in t[name] for t in turns):
                summary[name][f"{key}_by_turn"] = [(t["label"], t[name][key])
                                                   for t in turns if key in t[name]]
        if any("max_abs_err" in t[name] for t in turns):
            summary[name]["max_abs_err"] = max(t[name]["max_abs_err"] for t in turns
                                               if "max_abs_err" in t[name])
        if all("digest" in t[name] for t in turns):
            # across all four turns, and within each tree's two
            summary[name]["same_bits"] = len({t[name]["digest"] for t in turns}) == 1
            summary[name]["same_bits_each_tree"] = all(
                len({t[name]["digest"] for t in turns if t["label"] == lb}) == 1
                for lb in ("baseline", "this"))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
