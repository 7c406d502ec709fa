#!/usr/bin/env python3
"""Smoke run of rift_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the Pluto CBV
planner's eval step, its train step (the GRPO evaluator) and a fine-tune
round at full width, then the closed loop (Runner.eval and
Runner.train_cbv at the bench configuration), the fine-tuning zoo and the
CLI, on canonical tokens; then the same paths with the JAX CLI's
defaults: legacy (per-CBV) tokens, the PDM-Lite ego, walkers and statics;
then route files on route towns with the PlanT_medium ego and attention
recognition; then the per-tick loop with raw controls, classic PPO and
train_ego; then data collection, PlanT's behaviour-cloning fit and the
Pluto checkpoint converter; then the E2E camera egos (vad, uniad,
sparsedrive), their behaviour-cloning fit and their CLI; then the Runner
sharded over two ranks and `--render`; then the experiment protocols and
result tools (rift_tpu_torch/tools).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the six kernels from rift_tpu_torch/csrc (one nvcc each,
     started together) and print the card's name and power limit;
  2. hold each kernel against its plain version at the main path's shapes:
     attention in f32 (atol 1e-5) and bf16 (atol 2e-2), also at the tile
     edges of ATTN_EDGES, and at PlanT's shapes (19 tokens at S: the
     ego's D = 512, H = 8, head dim 64, and the recognizer's D = 128, H =
     4) and head dim 64's edges (PLANT_ATTN_EDGES), the PointNet in
     f32 at the act's and a fit step's shapes and at a legacy act's map
     polygons (N = S*C*64 = 12288 rows of [20, 10], a quarter of them
     masked whole, which must give exactly 0; atol 1e-4), the retrack
     rollout (at most 1% of the 9216 candidates diverging by more than
     2e-3), the refline matrices (at most 1% of the nearest points
     flipped, 1e-4 elsewhere), the HistoryEncoder stage at its three
     levels in f32 at one act call's N = 1536 and a bc_pluto fit step's
     N = 8192 history rows (atol 1e-4) and the whole-encoder kernel at N =
     1536, a ragged N = 1537, N = 8192 and a legacy act's N = S*C*32 =
     6144 in f32 (atol 1e-4); time
     kernel, plain version and, where one PyTorch call
     computes the same function, that call (scaled_dot_product_attention,
     nn.TransformerEncoder; timed only, the port never calls them; the
     attention's 17 launches of a few µs each, the retrack and the
     refline launch launched from Python and, as device time, replayed
     from a CUDA graph), with the PointNet, the stage
     and the whole encoder timed at the fit's and the legacy act's shapes
     too; then
     the gradients through the attention, PointNet and stage autograd
     Functions against the plain versions' gradients (f32, atol 1e-4);
  3. build the grid town (blocks=2, 2 lanes per direction) and reset
     TrafficEnv at S=64 scenarios x A=24 agents x C=3 CBVs for three seeds,
     with CBVs forced on slots 1..3 and a constant-speed history;
  4. a full-width PlutoModel (encoder and decoder depth 4, bf16 compute)
     from seeded weights: canonical map tokens once, then the eval
     pluto_cbv_act on each scene, with the launch counters read around
     that run: per call 17 attention launches, 1 whole-encoder launch,
     1 PointNet launch (plus 1 for the map tokens), no stage launch;
  5. one scene again in f32, through the kernels and through the plain
     versions on the card: the waypoints must agree within 1e-3 where the
     CBV mask holds;
  6. the train-mode pluto_cbv_act on each scene (also one retrack and one
     refline launch per call), with the counters read around that run;
     advantages and returns finite and varying;
  7. one scene's train act in f32 through the kernels and through the
     plain versions: adv_valid identical, at most 2% of candidate returns
     off by more than 1e-2;
  8. the three scenes' samples (576) appended to a ring buffer of 512,
     then two fine-tune rounds of `fit` (2 epochs, 1 warmup, batch 256: 4
     steps each), counters read around each (per step 17 attention, 1
     whole-encoder and 2 PointNet launches: the frozen encoder takes the
     forward-only kernel): finite losses, pi_head moved, every other
     parameter bit-identical;
  9. the closed loop at the bench configuration (S=64, A=24, C=3, depth 4,
     bf16, chunks of K=40 ticks; CBVs from rule recognition after tick
     25), counters read around each run: Runner.eval over two chunks;
     Runner.train_cbv over two chunks of train ticks, which fill its
     1024-sample buffer, then one fit round (16 epochs of 4 steps), pi_head
     moved and nothing else; world-only, eval and train env-steps/s timed
     as bench.py times them (K=40 chunks from the same reset, after a
     warm-up chunk, best of two); and one K=40 f32 eval chunk through the
     kernels and through the plain versions, a tick at a time: of the
     agents that were CBVs at some tick in either run at most 5%, and of
     all agents at most 1%, may end more than 1 cm apart or with another
     CBV flag;
 10. the fine-tuning zoo and the CLI: two train ticks at full width fill a
     256-sample buffer of every fine-tune key (rift, grpo, reinforce, rs,
     sft, bc, rtr, ppo), then one fit step each, counters read around
     each: finite losses, and only the key's trainable set moved (pi_head;
     pi_head and value_head for ppo_pluto; for bc_pluto every layer, the
     HistoryEncoder through the stage kernel: per step 17 attention, 3
     stage and 2 PointNet launches, no whole-encoder launch; grpo_pluto's
     frozen reference forward adds a second forward's launches); then
     `run.main` in train_cbv (rift_pluto, the behavior ego, S=64, 80 ticks,
     a 1024-sample buffer: one fit round, a checkpoint, a saved pretrain),
     eval from that pretrain, and eval --resume, which reads the
     statistics back and runs only the missing episode;
 11. the act steps on legacy tokens on phase 3's scenes with phase 4's
     model (per call 17 attention, 1 whole-encoder and 2 PointNet
     launches, the second for the CBVs' map polygons; train mode also 1
     retrack and 1 refline), the f32 eval and train acts through the
     kernels against the plain versions at phases 5 and 7's bounds, and
     one fit round on a 512-sample buffer of legacy samples (4 steps, the
     launches of phase 8's), pi_head moved and nothing else;
 12. the closed loop with the JAX CLI's eval defaults at the bench
     configuration: Runner.eval on legacy tokens with the PDM-Lite ego and
     2 walkers and 2 static obstacles per scenario, one K=40 chunk, exact
     launch counts; eval and world-only env-steps/s with the PDM ego as
     phase 9 times them; the kernels launched per env step (all of them,
     counted by torch.profiler) with the PDM and the rule ego; and one f32
     chunk through the kernels and the plain versions at phase 9's bounds;
 13. `run.main` with no ego and no override (pdm_lite, legacy tokens,
     in eval 2 walkers and 2 statics): eval for 40 ticks (exact launch
     counts), then train_cbv for 160 ticks;
 14. a route file written here (write_route_file: straight routes, Ls
     with a corner and crossing pairs, with weather): the Eval loader's
     first batch as a route town on the card and the shared town of all
     routes; the attention kernel against its plain version at PlanT's
     shapes at the batch's S and the CLI's 4 (f32 1e-5, bf16 2e-2);
     TrafficEnv.reset with each scenario on its route; two K=40
     chunks of rollout_chunk with the PlanT_medium ego (f32), the Pluto
     CBVs on legacy tokens and attention recognition, exact launch counts
     (per tick 8 attention launches for the ego and the act's 17, 4 per
     recognition tick); env-steps/s at the batch's S; one f32 chunk
     through the kernels and the plain versions at phase 9's bounds,
     the egos apart held to the CBVs' bound;
 15. `run.main` on the route file: eval with the plant ego and
     `--cbv_recog attention` at the default num_scenario over two
     batches, the last padded (exact launch counts; records with route
     ids and weather), `--shared_town` once, and train_cbv on route towns
     until a fit round (the re-tracking and reference-line kernels).
 16. the per-tick loop (`run.run_episode`), raw controls, classic PPO and
     train_ego at the bench configuration on legacy tokens: 40 ticks of
     the per-tick loop and of the fused one from one reset (pdm_lite,
     rift_pluto in eval, 2 walkers and 2 statics), every SimState and
     criteria field bit-equal (bounded at phase 9's share of agents
     apart only if the fused loop differs from itself), exact launch
     counts, both loops' env-steps/s; then `run.main`: train_cbv
     `--no_fused` to one fit round (a re-tracking and a reference-line
     launch every tick, exact counts, pi_head moved and nothing else),
     train_ego with the `ppo` ego (the rift_pluto CBVs' train act every
     tick; finite losses, ego weights moved), train_cbv with the classic
     `ppo` and `frea` CBVs (finite losses, weights moved, no hand-kernel
     launch, frea's warning), and eval with the `expert_disturb` ego;
 17. `--mode collect_data`, PlanT's fit, the Pluto checkpoint converter
     and the public API they brought: `run.collect_episode` at the bench
     configuration (pdm_lite, rift_pluto on legacy tokens, no walkers or
     statics, 3 CBVs) for 80 ticks into a CollectBuffer (exact launch
     counts, one frame a tick, the last frame the returned state's bits,
     env-steps/s beside phase 16's per-tick eval); PlanT's dataset built
     on the card from the frames (768 samples); PlanT_medium's fit (f32,
     12 steps of 64: 8 attention launches a step and no other) against the
     same fit through the plain versions (first-step gradients 1e-4, each
     step's loss 1e-4 relative), then its npz reloaded strictly (the same
     waypoints, bit for bit); a Lightning checkpoint fabricated here
     (fake_pluto_state_dict) through `load_pretrained_pluto` into a
     full-width `PlutoModel(points_norm="none")`: the PointNet kernel with
     `has_ln = 0` against its plain version at the reference-line and
     legacy map-polygon shapes (1e-4, whole-masked rows 0) and timed, the
     legacy eval act with exact launches, the f32 act through kernels vs
     plain versions (1e-3); `grpo_advantage` on one CBV against its row of
     the batched evaluator (1e-5; one re-tracking and one reference-line
     launch), a train act with `adv_debug` (advantages and returns bit
     for bit, finite `dbg_*`), and `init_sim_state` on CUDA;
 18. the E2E camera egos (seeded weights at the default width: dim 64, 4
     heads, 6 cameras of 24 x 48 x 8, a 16 x 16 BEV) at the bench
     configuration with the JAX CLI's eval defaults (rift_pluto on legacy
     tokens, 2 CBVs, 2 walkers and 2 statics): each variant's eval for 40
     ticks on the fused loop, exact hand-kernel launches (the CBVs' acts;
     the E2E ego launches none), env-steps/s beside phase 12's PDM-Lite
     eval; `vad` on the per-tick loop, bit-equal to the fused one; each
     variant's forward on the card against the same model on the CPU on
     one tick's cameras (`pred_wp`, `det_boxes`, `det_scores` within
     1e-4), the ego's ms, kernels and device ms per tick (torch.profiler);
     VAD's behaviour-cloning fit at S=8 from 40 PDM ticks (160 samples on
     the card, 2 epochs of 10 steps: ms per step, the second epoch's mean
     loss below the first's); `run.main --mode train_ego --ego_cfg
     sparsedrive` at S=8, then `--mode eval --ego_weights` its
     `sparsedrive_bc.npz` at S=64 (exact launches, the ego's weights the
     file's);
 19. data parallelism and `--render`: two ranks over gloo, both on the one
     card (NCCL refuses two ranks on one device: "Duplicate GPU detected"),
     each started as `chip_smoke.py --shard-rank R PORT DIR`, run
     `Runner.train_cbv` for one 80-tick episode at S=8 (4 scenarios a rank,
     the bench width, canonical tokens) and its fit round (a buffer of 128,
     2 epochs of 4 steps), while this process runs it unsharded: each
     rank's launches exact, the fit's parameters the same bits on both
     ranks, the gathered final states within phase 9's shares of agents
     apart (at S=8, one agent may be); a one-rank NCCL group through
     `init_distributed` and the collectives of the shard path; then
     `--render`: with matplotlib `run.main --render` for 10 ticks at S=4 and
     its files, without it the ImportError that names it; and the
     observer's world-frame candidates on the card against their host
     recomputation;
 20. the experiment protocols and result tools (rift_tpu_torch/tools): the
     quality protocol on phase 14's route file, `--smoke` as fresh
     processes a stage in the background, while this process runs its
     stages at TOOLS_ARGS (the smoke scale with 24 agents; each train_cbv
     run given a 16-sample buffer, so that it fits a round) through
     `run.main` with exact launches per stage (40 train acts and a fit
     round of 16 steps in each train_cbv stage, bc_pluto's through the
     stage kernel: 3 launches a step; 40 eval acts for pluto and
     rift_pluto, none for standard); the bc_pluto fit moving every
     HistoryEncoder tensor from the weights as built; each run's pretrain,
     tuned npz (moved by its fit), 3 eval rows, merged "±" table,
     check_eval, and the fitted run's RESULTS.md;
     `topology_eval --ticks 150` with that pretrain (both rows, the pluto
     row's launches exact); `ego_zoo_experiment --smoke`, whole with h5py,
     else the ImportError that names it at stage 1.

Prints the measurements, the card line and a `kernels` JSON line before
the last line, and `{"ok": true, "device": {...}}` last. Exits non-zero
without a CUDA device or without the rift_tpu_torch package beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

S, A, C = 64, 24, 3
SEEDS = (0, 1, 2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet), at 700 W
# dense peaks: f32 on the CUDA cores, bf16 on the tensor cores, and f32-
# accurate products on the tensor cores as three TF32 products (3xTF32:
# 495 / 3 TFLOP/s), the arithmetic of the PointNet and HistoryEncoder
# kernels, whose bounds count against it
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
DIM, HEADS, MODES, REFS, POINTS = 128, 4, 12, 4, 120
TOKENS = 32 + 64 + 1  # agents + map polygons + static objects
HIST = ((20, 32, 2), (10, 64, 4), (5, 128, 8))  # (T, D, H) per level, 2 blocks each
HIST_IN = (20, 9)  # the HistoryEncoder's input: T tokens of 9 channels
WINDOWS = (3, 3, 5)  # band width per level
EVAL_FRAMES = 40  # the GRPO evaluator's horizon
CHUNK = 40  # closed-loop ticks per rollout_chunk call, as bench.py's K
ACT_ATTENTION, ACT_STAGES = 17, 3  # launches per planner forward (stages: with gradients)
FIT_MAP_ROWS = 256 * 64  # a fit step's per-sample map rows: batch x lanes
FIT_HISTORY_ROWS = 256 * 32  # a fit step's history rows: batch x agents
# an act call's rows on legacy (per-CBV) tokens: each CBV's 64 map polygons
# through the PointNet and its 32 agents' histories through the encoder
LEGACY_MAP_ROWS, LEGACY_HISTORY_ROWS = S * C * 64, S * C * 32
LEGACY_POLYGONS_OUT = 0.25  # share of polygon slots masked whole in the check
# f32 closed loop, kernels vs plain versions: the most agents that may end
# apart, as a share of the agents that were CBVs and of all agents
LOOP_CBVS_APART, LOOP_AGENTS_APART = 0.05, 0.01
# PlanT: the ego (PlanT_medium, head dim 64) and the attention recognizer,
# over 16 vehicle tokens, 2 route tokens and the CLS token
PLANT_EGO = {"dim": 512, "num_layers": 8, "num_heads": 8}
PLANT_RECOG = {"dim": 128, "num_layers": 4, "num_heads": 4}
PLANT_TOKENS = 16 + 2 + 1
ROUTE_GROUPS = 5  # copies of the route file's four routes, 3 km apart
PER_TICK_BUFFER = 1024  # phase 16's per-tick train_cbv: filled within 80 ticks


def attention_shapes(B=S * C):
    """(B, Tq, Tk, D, H, kind) of the attention launches of one planner
    forward at batch B (an act call's S x C = 192 CBVs, or a fit step's
    samples): the ego state encoder, the scene encoder and the decoder (the
    HistoryEncoder's attention runs inside the stage kernel). Also the
    shapes tools/kernel_ab.py times."""
    out = [(B, 1, 6, DIM, HEADS, "sep")]
    out += [(B, TOKENS, TOKENS, DIM, HEADS, "self")] * 4
    for _ in range(4):
        out += [
            (B * MODES, REFS, REFS, DIM, HEADS, "self"),
            (B * REFS, MODES, MODES, DIM, HEADS, "qk"),
            (B, REFS * MODES, TOKENS, DIM, HEADS, "sep"),
        ]
    return out


# attention shapes beside the main path's (B, Tq, Tk, D, H, kind): the
# tails of the kernel's 16-row query and 16-key tiles, Tk at its limit of
# 128, head dim 16, Tq = 300, past the 8 warps' 128 rows of one pass, and
# short sequences four to a warp with a ragged last block and, at 15
# (batch row, head) pairs, a warp with an empty slot
ATTN_EDGES = [
    (64, 1, 1, DIM, HEADS, "sep"), (64, 4, 6, DIM, HEADS, "sep"),
    (64, 12, 97, DIM, HEADS, "kv"), (64, 48, 128, DIM, HEADS, "kv"),
    (64, 97, 128, DIM, HEADS, "kv"), (64, 97, 97, 64, HEADS, "self"),
    (16, 300, 33, DIM, HEADS, "kv"), (2101, 3, 2, DIM, HEADS, "sep"),
    (5, 4, 4, 96, 3, "self"),
]


# head dim 64 beside PlanT's own shapes (B, Tq, Tk, D, H, kind): Tk = 1
# (four short sequences to a warp), 17 (a key tail) and 128 (f32 K and V
# above 48 KB of shared memory), and Tq = 130, a second pass of 8 warps
PLANT_ATTN_EDGES = [
    (64, 1, 1, 128, 2, "sep"), (64, 17, 17, 512, 8, "self"),
    (64, 48, 128, 256, 4, "kv"), (16, 130, 128, 128, 2, "kv"),
]


def plant_attention_shapes(B=S):
    """PlanT's attention launches at batch B (S scenarios): the ego's and
    the recognizer's self-attention over the 19 tokens."""
    return {
        "plant_ego": (B, PLANT_TOKENS, PLANT_TOKENS, PLANT_EGO["dim"], PLANT_EGO["num_heads"],
                      "self"),
        "plant_recog": (B, PLANT_TOKENS, PLANT_TOKENS, PLANT_RECOG["dim"],
                        PLANT_RECOG["num_heads"], "self"),
    }


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


def graph_ms(torch, fn, iters=20):
    """Device ms of one call of `fn`, replayed from a CUDA graph: its
    launches back to back, without the host's cost of making them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # off the capture: first-use set-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, iters)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_inputs(torch, gen, shape, dtype):
    """Inputs in the layout the model hands the kernel: self-attention q/k/v
    are slices of one packed projection, m2m's q/k of a packed pair ("kv":
    k/v of a packed pair)."""
    B, Tq, Tk, D, H, kind = shape
    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    if kind == "self":
        qkv = rn(B, Tq, 3 * D)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    elif kind == "qk":
        qk = rn(B, Tq, 2 * D)
        q, k, v = qk[..., :D], qk[..., D:], rn(B, Tk, D)
    elif kind == "kv":
        kv = rn(B, Tk, 2 * D)
        q, k, v = rn(B, Tq, D), kv[..., :D], kv[..., D:]
    else:
        q, k, v = rn(B, Tq, D), rn(B, Tk, D), rn(B, Tk, D)
    bias = 0.5 * torch.randn(H, Tq, Tk, generator=gen, device=dev)
    pad = torch.rand(B, Tk, generator=gen, device=dev) < 0.3
    kpad = torch.where(pad, -1e9, 0.0)
    kpad[0] = -1e9  # a fully masked row
    return q, k, v, bias, kpad


def attention_errors(torch, attention, gen, shapes):
    """The kernel against its plain version at each shape, in f32 (atol
    1e-5) and bf16 (2e-2): the largest error of each type."""
    err = {"float32": 0.0, "bfloat16": 0.0}
    for shape in shapes:
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
    return err


def check_attention(torch, attention):
    """Kernel vs plain version at each main-path shape family and at the
    tile edges (ATTN_EDGES), f32 and bf16; then times of one act call's 17
    launches (bf16, as the model runs them)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = attention_shapes()
    err = attention_errors(torch, attention, gen, sorted(set(shapes)) + ATTN_EDGES)
    calls = [attention_inputs(torch, gen, s, torch.bfloat16) + (s[4],) for s in shapes]
    by_launch = {}
    for c, shape in zip(calls, shapes):
        key = "x".join(map(str, shape[:3]))
        if key not in by_launch:
            by_launch[key] = graph_ms(torch, lambda: attention.fused_attention(*c))
    return {
        **time_attention(torch, attention, calls, "bfloat16"),
        "max_abs_err": err["float32"],
        "max_abs_err_bf16": err["bfloat16"],
        "timed_work": f"the {len(calls)} launches of one act call at S={S}, bf16, launched "
                      "from Python (ms) and replayed from a CUDA graph (device_ms: device "
                      "time, without the host's cost of the launches)",
        "device_ms_by_launch": by_launch,
    }


def time_attention(torch, attention, calls, peak):
    """A set of attention launches ((q, k, v, bias, kpad, heads) each):
    kernel, plain version and one SDPA call each (float mask: bias plus
    key pad), launched from Python (ms) and replayed from a CUDA graph
    (device_*), and their bound: each input read once and each output
    written once at the card's memory rate, or 4 Tq Tk D operations a
    launch at `peak`."""
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
    bound, by = bound_ms(nbytes, flops, peak)
    kernel = lambda: [attention.fused_attention(*c) for c in calls]
    plain = lambda: [attention.fused_attention_ref(*c) for c in calls]
    library = lambda: [sdpa(q, k, v, attn_mask=m) for q, k, v, m in sdpa_in]
    return {
        "ms": cuda_ms(torch, kernel),
        "plain_ms": cuda_ms(torch, plain),
        "library_ms": cuda_ms(torch, library),
        "bound_ms": bound,
        "bound_by": by,
        "device_ms": graph_ms(torch, kernel),
        "device_plain_ms": graph_ms(torch, plain),
        "device_library_ms": graph_ms(torch, library),
    }


def check_plant_attention(torch, attention):
    """Kernel vs plain version at PlanT's shapes (the ego's D = 512, H = 8,
    head dim 64, and the recognizer's D = 128, H = 4, 19 tokens, batch S)
    and at head dim 64's edges (PLANT_ATTN_EDGES), f32 (1e-5) and bf16
    (2e-2); each timed in f32, as PlanT runs, with its bound counted at
    3xTF32 (the kernel's f32 arithmetic): one ego tick's 8 launches, one
    recognition tick's 4, one launch of each edge."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = {**plant_attention_shapes(),
              **{"x".join(map(str, e[:5])): e for e in PLANT_ATTN_EDGES}}
    out = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0}
    for name, shape in shapes.items():
        err = attention_errors(torch, attention, gen, [shape])
        out["max_abs_err"] = max(out["max_abs_err"], err["float32"])
        out["max_abs_err_bf16"] = max(out["max_abs_err_bf16"], err["bfloat16"])
        n = {"plant_ego": PLANT_EGO, "plant_recog": PLANT_RECOG}.get(name, {"num_layers": 1})
        calls = [attention_inputs(torch, gen, shape, torch.float32) + (shape[4],)
                 for _ in range(n["num_layers"])]
        B, Tq, Tk, D, H, _ = shape
        out[name] = {
            **time_attention(torch, attention, calls, "tf32x3"),
            "max_abs_err": err["float32"], "max_abs_err_bf16": err["bfloat16"],
            "timed_work": f"{len(calls)} launch(es), B={B}, Tq={Tq}, Tk={Tk}, D={D}, H={H}, f32",
        }
    return out


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


def points_bound(x, mask, w, dtype="tf32x3"):
    """The PointNet's bound on this run's inputs: the multiply-adds of the
    valid points (and the pooled half of the concatenated product once per
    row), each input read once and the output written once."""
    N, _, Cin = x.shape
    per_point = Cin * 128 + 128 * 256 + 256 * 256 + 256 * DIM
    flops = 2 * int(mask.sum()) * per_point + 2 * N * 256 * 256
    nbytes = x.numel() * 4 + mask.numel() + sum(t.numel() for t in w) * 4 + N * DIM * 4
    return bound_ms(nbytes, flops, dtype)


def check_points(torch, points, num_lanes):
    """Kernel vs plain version at the reference-line shape (one launch per
    act call), the map-token shape (once per episode) and a fit step's
    map-row shape (N = 256 samples x 64 lanes of 20 points, every point
    valid); times of the per-call reference-line launch and of the fit's
    map-row launch, each with its bound (3xTF32, and f32 on the CUDA cores
    for comparison)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = 0.0
    shapes = ((S * C * REFS, POINTS, 6, True), (num_lanes, 20, 10, False),
              (FIT_MAP_ROWS, 20, 10, False))
    for N, P, Cin, prefix in shapes:
        x, mask, w = points_inputs(torch, gen, N, P, Cin, prefix)
        got = points.points_encoder(x, mask, w, DIM)
        ref = points.points_forward_ref(x, mask, w)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        err = max(err, e)
        if not e <= 1e-4:
            raise AssertionError(f"points {(N, P, Cin)}: max err {e} > 1e-4")

    # the legacy map shape: whole polygons in or out, as the features' masks
    # (a slot past the lanes in range is masked whole and encodes to 0)
    lx, lmask, lw = points_inputs(torch, gen, LEGACY_MAP_ROWS, 20, 10, False)
    out_rows = torch.rand(LEGACY_MAP_ROWS, generator=gen, device="cuda") < LEGACY_POLYGONS_OUT
    lmask[out_rows] = False
    got = points.points_encoder(lx, lmask, lw, DIM)
    ref = points.points_forward_ref(lx, lmask, lw)
    torch.cuda.synchronize()
    legacy_err = (got - ref).abs().max().item()
    if not (legacy_err <= 1e-4 and not got[out_rows].any() and not ref[out_rows].any()):
        raise AssertionError(f"points legacy map rows: max err {legacy_err} > 1e-4, or a "
                             "masked polygon not 0")
    err = max(err, legacy_err)
    legacy_bound, legacy_by = points_bound(lx, lmask, lw)

    x, mask, w = points_inputs(torch, gen, S * C * REFS, POINTS, 6, True)
    bound, by = points_bound(x, mask, w)
    fx, fmask, fw = points_inputs(torch, gen, FIT_MAP_ROWS, 20, 10, False)
    fit_bound, fit_by = points_bound(fx, fmask, fw)
    return {
        "ms": cuda_ms(torch, lambda: points.points_encoder(x, mask, w, DIM)),
        "plain_ms": cuda_ms(torch, lambda: points.points_forward_ref(x, mask, w)),
        "library_ms": None,
        "bound_ms": bound,
        "bound_by": by,
        "bound_ms_f32_cuda_cores": points_bound(x, mask, w, "float32")[0],
        "max_abs_err": err,
        "timed_work": f"the reference-line launch of one act call, N={x.shape[0]}, "
                      f"P={POINTS}, f32",
        "fit_ms": cuda_ms(torch, lambda: points.points_encoder(fx, fmask, fw, DIM), iters=10),
        "fit_plain_ms": cuda_ms(torch, lambda: points.points_forward_ref(fx, fmask, fw),
                                iters=5),
        "fit_bound_ms": fit_bound,
        "fit_bound_by": fit_by,
        "fit_bound_ms_f32_cuda_cores": points_bound(fx, fmask, fw, "float32")[0],
        "fit_timed_work": f"a fit step's map-row launch, N={FIT_MAP_ROWS}, P=20, C=10, "
                          "every point valid, f32",
        "legacy_ms": cuda_ms(torch, lambda: points.points_encoder(lx, lmask, lw, DIM)),
        "legacy_plain_ms": cuda_ms(torch, lambda: points.points_forward_ref(lx, lmask, lw),
                                   iters=10),
        "legacy_bound_ms": legacy_bound,
        "legacy_bound_by": legacy_by,
        "legacy_bound_ms_f32_cuda_cores": points_bound(lx, lmask, lw, "float32")[0],
        "legacy_max_abs_err": legacy_err,
        "legacy_timed_work": f"the map-polygon launch of one act call on legacy tokens, "
                             f"N={LEGACY_MAP_ROWS}, P=20, C=10, {int(out_rows.sum())} "
                             "polygons masked whole, f32",
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
    kernel = lambda: retrack.retrack_rollout(pos, yaw, v0)
    return {
        "ms": cuda_ms(torch, kernel),
        "plain_ms": cuda_ms(torch, lambda: retrack.retrack_rollout_ref(pos, yaw, v0), iters=3),
        "library_ms": None,
        "bound_ms": bound,
        "bound_by": by,
        "max_abs_err": max(errs),
        "max_abs_err_center_heading_speed": errs,
        "diverged_share": share,
        "diverged_max_err": err.max().item(),
        "timed_work": f"one launch, G={G} candidates, T={T}, f32, launched from Python (ms) "
                      "and replayed from a CUDA graph (device_ms)",
        "device_ms": graph_ms(torch, kernel),
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
    kernel = lambda: refline.refline_matrices(*args)
    return {
        "ms": cuda_ms(torch, kernel),
        "plain_ms": cuda_ms(torch, lambda: refline.refline_matrices_ref(*args)),
        "library_ms": None,
        "bound_ms": bound,
        "bound_by": by,
        "max_abs_err": err,
        "flipped_share": flips,
        "timed_work": f"one launch, BR={BR} pairs, MT={MT}, Nr={POINTS}, f32, launched from "
                      "Python (ms) and replayed from a CUDA graph (device_ms)",
        "device_ms": graph_ms(torch, kernel),
    }


def stage_inputs(torch, gen, N, T, D, H, window):
    """One HistoryEncoder level's stage operands at the main path's shape:
    x [N, T, D], the 24 block weights (LN scales near 1, fan-in scaled
    matrices) and the two band-plus-RPB biases."""
    from rift_tpu_torch.ops.history import STAGE_WNAMES, band_rpb_bias, weight_shapes

    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    ws = []
    for name, shape in zip(STAGE_WNAMES * 2, weight_shapes(D) * 2):
        if name.endswith("scale"):
            ws.append(1.0 + 0.1 * rn(*shape))
        elif len(shape) == 1:
            ws.append(0.1 * rn(*shape))
        else:
            ws.append(rn(*shape) / math.sqrt(shape[0]))
    biases = [band_rpb_bias(0.5 * rn(H, 2 * window - 1), T, window) for _ in range(2)]
    return rn(N, T, D), ws, biases


def library_stage(torch, D, H, ws, biases, N):
    """nn.TransformerEncoder (2 pre-LN layers, tanh GELU, feed-forward 3D)
    loaded with one stage's weights, and its float attention mask
    [N*H, T, T]: one PyTorch call of the same function (timed only)."""
    F = torch.nn.functional
    layer = torch.nn.TransformerEncoderLayer(
        D, H, dim_feedforward=3 * D, dropout=0.0,
        activation=lambda x: F.gelu(x, approximate="tanh"),
        layer_norm_eps=1e-5, batch_first=True, norm_first=True,
    )
    enc = torch.nn.TransformerEncoder(layer, 2, enable_nested_tensor=False).cuda().eval()
    with torch.no_grad():
        for blk, lay in enumerate(enc.layers):
            w = ws[12 * blk:12 * blk + 12]
            lay.norm1.weight.copy_(w[0]), lay.norm1.bias.copy_(w[1])
            lay.self_attn.in_proj_weight.copy_(w[2].T), lay.self_attn.in_proj_bias.copy_(w[3])
            lay.self_attn.out_proj.weight.copy_(w[4].T), lay.self_attn.out_proj.bias.copy_(w[5])
            lay.norm2.weight.copy_(w[6]), lay.norm2.bias.copy_(w[7])
            lay.linear1.weight.copy_(w[8].T), lay.linear1.bias.copy_(w[9])
            lay.linear2.weight.copy_(w[10].T), lay.linear2.bias.copy_(w[11])
    # the library applies one mask to both layers: block 0's bias
    mask = biases[0][None].expand(N, -1, -1, -1).reshape(N * H, *biases[0].shape[1:])
    return enc, mask.contiguous()


def check_history(torch, history):
    """Stage kernel vs plain version at the three HistoryEncoder levels of
    one act call (N = S*A history rows) and of a fit step that trains the
    encoder (N = FIT_HISTORY_ROWS), f32, atol 1e-4 (two LocalBlocks,
    products up to 3D = 384 deep summed in another order); times of the
    three launches at each N against the plain version and
    nn.TransformerEncoder, whose error against the kernel (both blocks
    given block 0's bias, as its one mask) is reported, not bounded. The
    bound counts the multiply-adds of the products, and of the attention
    at the pairs the band leaves. The fit's numbers carry the prefix
    `fit_`; `max_abs_err` is the larger of the two N's."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for tag, N in (("", S * A), ("fit_", FIT_HISTORY_ROWS)):
        calls, err, lib_err, flops, nbytes = [], 0.0, 0.0, 0, 0
        for (T, D, H), window in zip(HIST, WINDOWS):
            x, ws, biases = stage_inputs(torch, gen, N, T, D, H, window)
            got = history.local_stage(x, ws, *biases, H)
            ref = history.local_stage_ref(x, ws, *biases, H)
            torch.cuda.synchronize()
            e = (got - ref).abs().max().item()
            err = max(err, e)
            if not e <= 1e-4:
                raise AssertionError(f"history stage N={N} T={T} D={D}: max err {e} > 1e-4")
            enc, mask = library_stage(torch, D, H, ws, biases, N)
            with torch.no_grad():
                same = history.local_stage(x, ws, biases[0], biases[0], H)
                lib_err = max(lib_err, (enc(x, mask=mask) - same).abs().max().item())
            calls.append((x, ws, biases, H, (enc, mask)))
            for b in biases:
                # per block: the qkv, out, mlp1 and mlp2 products, and QK and
                # AV over the (query, key) pairs the band leaves (exp(-1e9) is 0)
                keys = int((b[0] > -1e8).sum())
                flops += 2 * N * (10 * T * D * D + 2 * keys * D)
            nbytes += 4 * (2 * x.numel() + sum(w.numel() for w in ws) + 2 * biases[0].numel())
        bound, by = bound_ms(nbytes, flops, "tf32x3")
        with torch.no_grad():
            lib_ms = cuda_ms(torch, lambda: [enc(x, mask=m) for x, _, _, _, (enc, m) in calls])
        out.update({
            f"{tag}ms": cuda_ms(torch, lambda: [history.local_stage(x, w, *b, H)
                                                for x, w, b, H, _ in calls]),
            f"{tag}plain_ms": cuda_ms(torch, lambda: [history.local_stage_ref(x, w, *b, H)
                                                      for x, w, b, H, _ in calls]),
            f"{tag}library_ms": lib_ms,
            f"{tag}bound_ms": bound,
            f"{tag}bound_by": by,
            f"{tag}bound_ms_f32_cuda_cores": bound_ms(nbytes, flops, "float32")[0],
            f"{tag}max_abs_err": err,
            f"{tag}library_max_abs_err": lib_err,
            f"{tag}gflop": flops / 1e9,
            f"{tag}timed_work": f"the 3 launches of {'a bc_pluto fit step' if tag else 'one act call'}"
                                f", N={N} rows, (T, D, H) = {HIST}, f32",
        })
        del calls
    out["max_abs_err"] = max(out["max_abs_err"], out["fit_max_abs_err"])
    return out


def encoder_inputs(torch, gen, N):
    """The HistoryEncoder's flat params (seeded: LN scales near 1, fan-in
    scaled matrices, RPB tables of a few tenths) and x [N, 20, 9]."""
    from rift_tpu_torch.ops.history import encoder_shapes

    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
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
    return rn(N, *HIST_IN), W


def conv_taps(T, stride=1, rows=None):
    """The (output row, input row) pairs of a k=3 XLA-SAME convolution over
    T rows that fall on input rows, pads excluded, at `rows` of its output
    (all by default)."""
    out_len = -(-T // stride)
    left = max((out_len - 1) * stride + 3 - T, 0) // 2
    rows = range(out_len) if rows is None else rows
    return sum(0 <= o * stride - left + k < T for o in rows for k in range(3))


def encoder_bound(history, x, W, dtype="tf32x3"):
    """The whole encoder's bound on x [N, 20, 9]: the multiply-adds the last
    token needs, the input read once, the weights once, the output written
    once. Returns (ms, bound_by, GFLOP)."""
    N = x.shape[0]
    (T, C), O = HIST_IN, HIST[-1][1]
    macs = conv_taps(T) * C * HIST[0][1]  # the tokenizer
    for lv, ((Tl, D, _), w) in enumerate(zip(HIST, WINDOWS)):
        # rows whose Q, out-projection and MLP the output needs: all, but in
        # the last level's second block only those its lateral reads
        last = lv + 1 == len(HIST)
        for q in (Tl, Tl - history.LATERAL_ROWS[lv][0] + 1 if last else Tl):
            macs += 2 * Tl * D * D + 8 * q * D * D + 2 * q * min(w, Tl) * D
        if not last:
            macs += conv_taps(Tl, 2) * D * 2 * D  # the stride-2 conv
        macs += conv_taps(Tl, 1, history.LATERAL_ROWS[lv]) * D * O  # the lateral
    macs += len(history.fpn_weights()) * O  # the FPN resizes
    macs += conv_taps(T, 1, (T - 1,)) * O * O  # the final conv
    flops = 2 * N * macs
    nbytes = 4 * (x.numel() + N * O + sum(w.numel() for w in W.values()))
    return (*bound_ms(nbytes, flops, dtype), flops / 1e9)


def check_history_encoder(torch, history):
    """The whole-encoder kernel vs its plain version at one act call's N =
    S*A history rows, at a ragged N (the last block's share not a multiple
    of its chunk) and at a fit step's N = 256 x 32 history rows, f32, atol
    1e-4 (six LocalBlocks, three convolutions and the FPN, summed in
    another order); times of one launch at N = S*A and at the fit's N. The
    bound counts the multiply-adds the last token needs: the convolutions'
    taps that fall on rows (pads excluded); every row of the tokenizer, the
    downsamples and the first five blocks; in the sixth block the K and V
    of every row, but the Q, the out-projection and the MLP only at the
    rows the lateral reads; attention over the band's keys; the laterals,
    the FPN resizes and the final conv at the rows the last token reads."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    err = 0.0
    for N in (S * A, S * A + 1, FIT_HISTORY_ROWS, LEGACY_HISTORY_ROWS):
        x, W = encoder_inputs(torch, gen, N)
        got = history.history_encoder(x, W)
        ref = history.history_encoder_ref(x, W)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        err = max(err, e)
        if not (e <= 1e-4 and got.shape == (N, 128)):
            raise AssertionError(f"history encoder N={N}: max err {e} > 1e-4")
    x, W = encoder_inputs(torch, gen, S * A)
    bound, by, gflop = encoder_bound(history, x, W)
    fx, fW = encoder_inputs(torch, gen, FIT_HISTORY_ROWS)
    fit_bound, fit_by, fit_gflop = encoder_bound(history, fx, fW)
    lx, lW = encoder_inputs(torch, gen, LEGACY_HISTORY_ROWS)
    legacy_bound, legacy_by, legacy_gflop = encoder_bound(history, lx, lW)
    return {
        "ms": cuda_ms(torch, lambda: history.history_encoder(x, W)),
        "plain_ms": cuda_ms(torch, lambda: history.history_encoder_ref(x, W)),
        "library_ms": None,
        "bound_ms": bound,
        "bound_by": by,
        "bound_ms_f32_cuda_cores": encoder_bound(history, x, W, "float32")[0],
        "max_abs_err": err,
        "gflop": gflop,
        "timed_work": f"one launch, N={S * A} rows of {HIST_IN}, f32",
        "fit_ms": cuda_ms(torch, lambda: history.history_encoder(fx, fW), iters=10),
        "fit_plain_ms": cuda_ms(torch, lambda: history.history_encoder_ref(fx, fW), iters=5),
        "fit_bound_ms": fit_bound,
        "fit_bound_by": fit_by,
        "fit_bound_ms_f32_cuda_cores": encoder_bound(history, fx, fW, "float32")[0],
        "fit_gflop": fit_gflop,
        "fit_timed_work": f"one launch, N={FIT_HISTORY_ROWS} rows (a fit step's), f32",
        "legacy_ms": cuda_ms(torch, lambda: history.history_encoder(lx, lW), iters=10),
        "legacy_plain_ms": cuda_ms(torch, lambda: history.history_encoder_ref(lx, lW), iters=5),
        "legacy_bound_ms": legacy_bound,
        "legacy_bound_by": legacy_by,
        "legacy_bound_ms_f32_cuda_cores": encoder_bound(history, lx, lW, "float32")[0],
        "legacy_gflop": legacy_gflop,
        "legacy_timed_work": f"one launch, N={LEGACY_HISTORY_ROWS} rows (an act call's on "
                             "legacy tokens), f32",
    }


def make_scene(torch, tmap, seed):
    """Reset S scenarios, force CBVs on slots 1..C and give every live agent
    a 2 s constant-speed history along its heading: a full act step at
    tick 0, where rule recognition has not run yet (phase 9's closed loop
    recognizes its CBVs after the warm-up)."""
    from rift_tpu_torch.scenario import TrafficEnv, wake_all_bvs

    env = TrafficEnv(
        tmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=seed, device=tmap.device
    )
    state, _, spec = env.reset()
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


def check_gradients(torch, attention, points, history):
    """The autograd Functions around the kernels: gradients through the
    kernels equal the plain versions' gradients (both backwards recompute
    through the plain version) at the scene encoder's attention shape, one
    per-sample map PointNet shape and the first HistoryEncoder stage, f32."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    err = {}
    B, T, D, H = S * C, TOKENS, DIM, HEADS  # the scene encoder
    args = attention_inputs(torch, gen, (B, T, T, D, H, "sep"), torch.float32)
    w = torch.randn(B, T, D, generator=gen, device="cuda")
    x, mask, pw = points_inputs(torch, gen, 256 * 64, 20, 10, False)
    g = torch.randn(x.shape[0], DIM, generator=gen, device="cuda")
    (Ts, Ds, Hs), window = HIST[0], WINDOWS[0]
    hx, hw, hb = stage_inputs(torch, gen, S * A, Ts, Ds, Hs, window)
    hg = torch.randn(hx.shape, generator=gen, device="cuda")
    cases = {
        "fused_attention": (
            lambda xs: attention.fused_attention(*xs, args[4], H),
            lambda xs: attention.fused_attention_ref(*xs, args[4], H), args[:4], w),
        "points_encoder": (
            lambda xs: points.points_encoder(xs[0], mask, xs[1:], DIM),
            lambda xs: points.points_forward_ref(xs[0], mask, xs[1:]), [x, *pw], g),
        "local_stage": (
            lambda xs: history.local_stage(xs[0], xs[3:], xs[1], xs[2], Hs),
            lambda xs: history.local_stage_ref(xs[0], xs[3:], xs[1], xs[2], Hs),
            [hx, *hb, *hw], hg),
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


def kernel_counters():
    """{kernel: (module, counter)}: the launch counter of each wrapper."""
    from rift_tpu_torch.ops import attention, history, points, refline, retrack

    return {
        "fused_attention": (attention, "launches"), "points_encoder": (points, "launches"),
        "retrack_rollout": (retrack, "launches"), "refline_matrices": (refline, "launches"),
        "local_stage": (history, "launches"), "history_encoder": (history, "encoder_launches"),
    }


def read_launches(counters):
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def zero_launches(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


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
    of them are real (rollout.store_chunk)."""
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


def act_launches(n_calls, train=False, map_tokens=False, legacy=False):
    """Kernel launches of n planner act calls (eval or train) and, when the
    canonical map tokens are computed in the same run, their PointNet. On
    legacy tokens each call also encodes its CBVs' map polygons: a second
    PointNet launch."""
    return {
        "fused_attention": ACT_ATTENTION * n_calls,
        "points_encoder": (2 if legacy else 1) * n_calls + int(map_tokens),
        "retrack_rollout": n_calls if train else 0,
        "refline_matrices": n_calls if train else 0,
        "local_stage": 0,
        "history_encoder": n_calls,
    }


def fit_launches(steps, encoder_trains=False, forwards=1):
    """Per fit step: `forwards` forwards on the batch's per-sample features
    (its attention; the per-sample map rows and the ref lines through the
    PointNet; the HistoryEncoder in one whole-encoder launch when no
    gradient flows through it, else through the three stage launches)."""
    n = steps * forwards
    return {"fused_attention": ACT_ATTENTION * n, "points_encoder": 2 * n,
            "retrack_rollout": 0, "refline_matrices": 0,
            "local_stage": ACT_STAGES * n if encoder_trains else 0,
            "history_encoder": 0 if encoder_trains else n}


def add(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def check_counts(path, got, want):
    if got != want:
        raise AssertionError(f"{path} launches {got}, expected {want}")


def params_moved(torch, model, before):
    """(total |change| of pi_head, names of other parameters that changed)."""
    moved, changed = 0.0, []
    for n, p in model.named_parameters():
        if n.startswith("planning_decoder.pi_head"):
            moved += (p.detach() - before[n]).abs().sum().item()
        elif not torch.equal(p.detach(), before[n]):
            changed.append(n)
    return moved, changed


def closed_loop(torch, tmap, counters, plain_versions, kernel_versions):
    """Phase 9: the Runner's eval and fine-tune rounds at the bench
    configuration, env-steps/s as bench.py measures them, and an f32 eval
    chunk through the kernels against the plain versions."""
    from rift_tpu_torch.models.pluto import PlutoModel, canonical_map_tokens
    from rift_tpu_torch.rollout import rollout_chunk
    from rift_tpu_torch.runner import Runner, RunnerConfig

    t0 = time.perf_counter()
    cfg = RunnerConfig(num_scenarios=S, num_agents=A, max_cbvs=C, max_episode_ticks=2 * CHUNK,
                       canonical=True)
    runner = Runner(tmap, cfg)
    acts = cfg.max_episode_ticks
    out, launches = {}, {}

    # Runner.eval: one episode of two K=40 chunks
    zero_launches(counters)
    t1 = time.perf_counter()
    stats = runner.eval(num_episodes=1, chunk=CHUNK)
    torch.cuda.synchronize()
    out["runner_eval_s"] = time.perf_counter() - t1
    launches["closed_loop_eval"] = read_launches(counters)
    check_counts("Runner.eval", launches["closed_loop_eval"], act_launches(acts, map_tokens=True))
    recs = runner.stats.records
    promoted = sum(r.cbv_count for r in recs)
    if stats.total_routes != S or not 0.0 <= stats.avg_route_completion <= 100.0 or promoted == 0:
        raise AssertionError(f"Runner.eval: {stats.total_routes} routes, RC "
                             f"{stats.avg_route_completion}, {promoted} CBVs promoted")
    if not all(math.isfinite(r.driving_score) for r in recs):
        raise AssertionError("Runner.eval: non-finite driving scores")
    out["eval_stats"] = {
        "avg_driving_score": stats.avg_driving_score,
        "avg_route_completion": stats.avg_route_completion,
        "cbvs_promoted": promoted,
        "cbv_mean_speed": stats.cbv_mean_speed,
        "route_progress_m": stats.route_progress_m,
    }

    # Runner.train_cbv: two chunks of train ticks fill the buffer, then fit
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    zero_launches(counters)
    t1 = time.perf_counter()
    losses = runner.train_cbv(num_episodes=1, chunk=CHUNK)
    torch.cuda.synchronize()
    out["runner_train_cbv_s"] = time.perf_counter() - t1
    launches["closed_loop_train"] = read_launches(counters)
    if runner.train_rounds != 1:
        raise AssertionError(f"Runner.train_cbv: buffer holds {runner.buffer.size} of "
                             f"{cfg.buffer_capacity} after {acts} ticks; no fit round")
    steps = cfg.train.epochs * (cfg.buffer_capacity // cfg.train.batch_size)
    check_counts("Runner.train_cbv", launches["closed_loop_train"],
                 add(act_launches(acts, train=True), fit_launches(steps)))
    moved, changed = params_moved(torch, runner.model, before)
    if not (all(math.isfinite(x) for x in losses[0]) and moved > 0.0) or changed:
        raise AssertionError(f"train_cbv: losses {losses}, pi_head moved {moved}, "
                             f"other params changed: {changed}")
    out["fit"] = {"steps": steps, "epoch_losses": losses[0], "pi_head_abs_delta": moved}

    # env-steps/s as bench.py: K=40 chunks from one reset, after a warm-up
    # chunk, the best of two trials
    state0, crit0, spec = runner.env.reset()
    tok = runner._map_tokens()

    def steps_per_s(chunks, **kw):
        run = lambda s, c, k: rollout_chunk(runner.model, tmap, spec, s, c, max_cbvs=C,
                                            num_steps=CHUNK, canonical=True, map_tok=tok,
                                            tick=k * CHUNK, **kw)
        run(state0, crit0, 0)
        best = math.inf
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            s, c = state0, crit0
            for k in range(chunks):
                s, c, _ = run(s, c, k)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t1)
        return chunks * CHUNK * S / best

    out["world_only_env_steps_per_s"] = steps_per_s(2, with_policy=False)
    out["eval_env_steps_per_s"] = steps_per_s(2)
    out["train_env_steps_per_s"] = steps_per_s(1, train=True)

    # one f32 eval chunk from the reset through the kernels and through the
    # plain versions, a tick at a time to record every agent that was a CBV
    # (recognised from tick 26 on). The loop is chaotic (a near-tied
    # candidate choice, nearest-lane and collision flags), so the share of
    # agents ending apart is bounded, not forbidden: among the agents that
    # were CBVs in either run, which act on the kernels' output, and among
    # all agents
    model32 = PlutoModel(encoder_depth=cfg.encoder_depth, decoder_depth=cfg.decoder_depth,
                         dtype=torch.float32).eval()
    model32.load_state_dict(runner.model.state_dict())

    tok32 = {}

    def f32_tick(s, c, k):
        if k == 0:  # the map tokens through this run's versions of the kernels
            tok32["map"] = canonical_map_tokens(model32, tmap)
        return rollout_chunk(model32, tmap, spec, s, c, max_cbvs=C, num_steps=1,
                             canonical=True, map_tok=tok32["map"], tick=k)[:2]

    out.update(f32_loop_apart(torch, f32_tick, state0, crit0, plain_versions,
                              kernel_versions, "f32 closed loop"))
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def f32_loop_apart(torch, tick, state0, crit0, plain_versions, kernel_versions, what,
                   ego_on_kernels=False):
    """One f32 chunk of CHUNK ticks from (state0, crit0), a tick at a time
    (`tick(state, crit, k) -> (state, crit)`), through the kernels and
    through the plain versions, recording every agent that was a CBV. The
    loop is chaotic (a near-tied candidate choice, nearest-lane and
    collision flags), so the share of agents ending apart (more than 1 cm,
    or another CBV flag) is bounded, not forbidden: among the agents that
    were CBVs in either run, which act on the kernels' output, and among
    all agents. With `ego_on_kernels` (a learned ego, which also acts on
    the kernels' output) the share of egos apart has the CBVs' bound."""
    def run():
        s, c, ever_cbv = state0, crit0, state0.is_cbv.clone()
        for k in range(CHUNK):
            s, c = tick(s, c, k)
            ever_cbv |= s.is_cbv
        return s, ever_cbv

    got, got_cbv = run()
    plain_versions()
    try:
        ref, ref_cbv = run()
    finally:
        kernel_versions()
    torch.cuda.synchronize()
    cbv = got_cbv | ref_cbv
    if not torch.isfinite(got.pos).all() or not bool(cbv.any()):
        raise AssertionError(f"{what}: non-finite positions or no CBV")
    apart = torch.linalg.norm(got.pos - ref.pos, dim=-1) > 1e-2
    apart |= got.is_cbv != ref.is_cbv
    out = {
        "f32_cbvs": int(cbv.sum()),
        "f32_cbvs_apart_share": apart[cbv].float().mean().item(),
        "f32_agents_apart_share": apart.float().mean().item(),
        "f32_egos_apart": int(apart[:, 0].sum()),
        "f32_max_pos_err_of_the_rest": (
            (got.pos - ref.pos)[~apart].abs().max().item() if (~apart).any() else 0.0),
    }
    egos_share = out["f32_egos_apart"] / apart.shape[0]
    if not (out["f32_cbvs_apart_share"] <= LOOP_CBVS_APART
            and out["f32_agents_apart_share"] <= LOOP_AGENTS_APART
            and (not ego_on_kernels or egos_share <= LOOP_CBVS_APART)):
        raise AssertionError(
            f"{what}: {out['f32_cbvs_apart_share']} of {out['f32_cbvs']} CBVs apart (bound "
            f"{LOOP_CBVS_APART}), {out['f32_agents_apart_share']} of all agents apart (bound "
            f"{LOOP_AGENTS_APART}), {out['f32_egos_apart']} of {apart.shape[0]} egos apart "
            f"(bound {LOOP_CBVS_APART if ego_on_kernels else 'none'})")
    return out


FINE_TUNED = ("rift_pluto", "grpo_pluto", "reinforce_pluto", "rs_pluto", "sft_pluto",
              "bc_pluto", "rtr_pluto", "ppo_pluto")
ZOO_BUFFER, ZOO_STEPS = 256, 2  # the first step of a round runs at lr 0 (warmup)
# what bc_pluto's loss reads, across the model: every tensor there moves
# (the heads no loss reads, agent_predictor and hidden_proj, and biases
# whose gradient is 0, such as the yaw and speed heads', stay)
BC_MOVES = ("AgentEncoder_0.HistoryEncoder_0", "MapEncoder_0.PointsEncoder_0", "enc0.",
            "enc3.", "planning_decoder.layer0.", "planning_decoder.layer3.",
            "planning_decoder.r_encoder", "planning_decoder.loc_head",
            "planning_decoder.pi_head", "ref_free_decoder")


def zoo_and_cli(torch, tmap, counters, scene):
    """Phase 10: one short fit round of every fine-tune key on samples of
    two full-width train ticks, then the CLI's train_cbv, eval and eval
    --resume at the bench configuration."""
    import dataclasses
    import os
    import shutil

    from rift_tpu_torch import policies, run
    from rift_tpu_torch.rl.trainer import trainable_mask
    from rift_tpu_torch.rollout import rollout_chunk
    from rift_tpu_torch.scenario import init_criteria

    t0 = time.perf_counter()
    out, launches = {"zoo": {}}, {}
    state, spec = scene
    pols = {k: policies.CBV_POLICY_LIST[k](tmap, {"buffer_capacity": ZOO_BUFFER,
                                                   "canonical_tokens": True})
            for k in FINE_TUNED}
    src = pols["rift_pluto"]
    _, _, extras = rollout_chunk(src.model, tmap, spec, state, init_criteria(S, A, "cuda"),
                                 max_cbvs=C, num_steps=2, train=True,
                                 canonical=True, map_tok=src.map_tokens(), tick=0)
    for key, pol in pols.items():
        pol.store_chunk(extras)
        if not pol.buffer_full():
            raise AssertionError(f"{key}: buffer holds {pol.buffer.size} of {ZOO_BUFFER}")
        pol.train_cfg = dataclasses.replace(pol.train_cfg, epochs=ZOO_STEPS, warmup_epochs=0)
        mask = trainable_mask(pol.model, pol.train_cfg.trainable_prefixes)
        before = {n: p.detach().clone() for n, p in pol.model.named_parameters()}
        zero_launches(counters)
        losses = pol.train_round()
        torch.cuda.synchronize()
        path = f"fit_{key}"
        launches[path] = read_launches(counters)
        check_counts(path, launches[path], fit_launches(
            ZOO_STEPS, encoder_trains=key == "bc_pluto", forwards=2 if key == "grpo_pluto" else 1))
        changed = {n for n, p in pol.model.named_parameters() if not torch.equal(p.detach(), before[n])}
        frozen_moved = sorted(n for n in changed if not mask[n])
        groups = ("planning_decoder.pi_head",) + (("value_head",) if key == "ppo_pluto" else ())
        groups = BC_MOVES if key == "bc_pluto" else groups
        still = sorted(n for n in mask if n.startswith(groups) and n not in changed)
        if not all(math.isfinite(x) for x in losses) or frozen_moved or still:
            raise AssertionError(f"{key}: losses {losses}, frozen moved {frozen_moved[:5]}, "
                                 f"unmoved {still[:5]}")
        out["zoo"][key] = {"losses": losses, "tensors_moved": len(changed),
                           "tensors": len(mask)}
    del pols, src, extras

    cli_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    shutil.rmtree(cli_dir, ignore_errors=True)
    common = ["--ego_cfg", "behavior", "--cbv_cfg", "rift_pluto", "--num_scenario", str(S),
              "--num_agents", str(A), "--blocks", "2", "--max_ticks", str(2 * CHUNK),
              "--out_dir", cli_dir, "canonical_tokens=true"]
    pre = os.path.join(cli_dir, "pretrain.npz")
    zero_launches(counters)
    t1 = time.perf_counter()
    g = run.main(["--mode", "train_cbv", "--num_episodes", "1", "--save_pretrain", pre,
                  *common, "buffer_capacity=1024"])
    torch.cuda.synchronize()
    out["cli_train_cbv_s"] = time.perf_counter() - t1
    launches["cli_train_cbv"] = read_launches(counters)
    ckpt = os.path.join(cli_dir, "train_cbv", "behavior-rift_pluto-seed0", "model_ckpt")
    if g.total_routes != S or os.listdir(ckpt) != ["rift_pluto-episode_0"] or not os.path.exists(pre):
        raise AssertionError(f"CLI train_cbv: {g.total_routes} routes, checkpoints "
                             f"{os.listdir(ckpt)}, pretrain saved: {os.path.exists(pre)}")
    t1 = time.perf_counter()
    run.main(["--mode", "eval", "--num_episodes", "1", "--pretrain", pre, *common])
    results = os.path.join(cli_dir, "eval", "behavior-rift_pluto-seed0",
                           "simulation_results.json")
    with open(results) as f:
        first = json.load(f)["records"]
    g = run.main(["--mode", "eval", "--num_episodes", "2", "--resume", "--pretrain", pre,
                  *common])
    with open(results) as f:
        records = json.load(f)["records"]
    out["cli_eval_two_episodes_s"] = time.perf_counter() - t1
    if g.total_routes != 2 * S or len(records) != 2 * S or records[:S] != first:
        raise AssertionError(f"CLI eval --resume: {g.total_routes} routes, {len(records)} "
                             f"records, the first episode's kept: {records[:S] == first}")
    out["cli_eval"] = {"avg_driving_score": g.avg_driving_score,
                       "avg_route_completion": g.avg_route_completion}
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def legacy_path(torch, tmap, counters, scenes, model, plain_versions, kernel_versions):
    """Phase 11: the act steps and a fit on legacy (per-CBV) tokens, the JAX
    package's default, on phase 3's scenes with phase 4's bf16 model: per
    act call each CBV's 64 map polygons go through the PointNet (S*C*64
    rows, real masks) and its 32 agents' histories through the whole
    encoder (S*C*32 rows); no map tokens. Exact launch counts, the f32 act
    steps through the kernels against the plain versions at phases 5 and
    7's bounds, and one fit round that moves pi_head alone."""
    from rift_tpu_torch.models.pluto import PlutoModel, pluto_cbv_act
    from rift_tpu_torch.rl import TrainConfig, fit, rift_loss_fn, ring_append, ring_init
    from rift_tpu_torch.rl.buffer import _leaves

    t0 = time.perf_counter()
    out, launches = {}, {}
    zero_launches(counters)
    outs = [pluto_cbv_act(model, tmap, spec, state, max_cbvs=C) for state, spec in scenes]
    torch.cuda.synchronize()
    launches["legacy_eval_act"] = read_launches(counters)
    check_counts("legacy eval act", launches["legacy_eval_act"],
                 act_launches(len(scenes), legacy=True))
    for res in outs:
        if not torch.isfinite(res["traj"]).all() or int(res["mask"].sum()) != S * C:
            raise AssertionError("legacy eval act: non-finite waypoints or a wrong CBV mask")
    in_range = outs[0]["features"]["map"]["valid_mask"].any(-1).float().mean().item()
    state, spec = scenes[0]
    out["eval_act_ms"] = time_calls(
        torch, lambda: pluto_cbv_act(model, tmap, spec, state, max_cbvs=C), 10, warmup=2)
    out["map_polygon_slots_in_range_share"] = in_range

    model32 = PlutoModel(encoder_depth=4, decoder_depth=4, dtype=torch.float32).eval()
    model32.load_state_dict(model.state_dict())

    def kernels_and_plain(**kw):
        got = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, **kw)
        plain_versions()
        try:
            ref = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, **kw)
        finally:
            kernel_versions()
        torch.cuda.synchronize()
        return got, ref

    got, ref = kernels_and_plain()
    mask = ref["mask"]
    if not torch.equal(got["mask"], mask):
        raise AssertionError("legacy f32 CBV masks differ between kernels and plain versions")
    out["f32_traj_max_abs_err"] = (got["traj"][mask] - ref["traj"][mask]).abs().max().item()
    if not out["f32_traj_max_abs_err"] <= 1e-3:
        raise AssertionError(f"legacy f32 waypoints differ by {out['f32_traj_max_abs_err']}")

    zero_launches(counters)
    train_outs = [pluto_cbv_act(model, tmap, spec_, state_, max_cbvs=C, train=True)
                  for state_, spec_ in scenes]
    torch.cuda.synchronize()
    launches["legacy_train_act"] = read_launches(counters)
    check_counts("legacy train act", launches["legacy_train_act"],
                 act_launches(len(scenes), train=True, legacy=True))
    for res in train_outs:
        valid = res["adv_valid"]
        adv, ret = res["advantage"][valid], res["rollout_return"][valid]
        if int(valid.sum()) < S * C * MODES or not (torch.isfinite(adv).all()
                                                    and torch.isfinite(ret).all()):
            raise AssertionError("legacy train act: too few valid candidates or non-finite")
    out["train_act_ms"] = time_calls(
        torch, lambda: pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, train=True), 5,
        warmup=2)
    got, ref = kernels_and_plain(train=True)
    if not torch.equal(got["adv_valid"], ref["adv_valid"]):
        raise AssertionError("legacy f32 train act: adv_valid differs between kernels and plain")
    v = ref["adv_valid"]
    ret_err = (got["rollout_return"] - ref["rollout_return"])[v].abs()
    out["f32_return_off_share"] = (ret_err > 1e-2).float().mean().item()
    if not out["f32_return_off_share"] <= 0.02:
        raise AssertionError(f"legacy f32 train act: {out['f32_return_off_share']} of "
                             "returns off by > 1e-2")
    del model32, got, ref

    # one fit round on the legacy samples of the three train acts
    samples = [train_samples(torch, res) for res in train_outs]
    first = lambda t: {k: first(x) for k, x in t.items()} if isinstance(t, dict) else t[0]
    buf = ring_init(first(samples[0][0]), capacity=512)
    for smp, valid in samples:
        ring_append(buf, smp, valid)
    if not buf.full:
        raise AssertionError(f"legacy buffer holds {buf.size} of {buf.capacity}")
    cfg = TrainConfig(epochs=2, warmup_epochs=1)
    steps = cfg.epochs * (buf.size // cfg.batch_size)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(1)
    zero_launches(counters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = fit(model, buf, rift_loss_fn, cfg, gen)
    torch.cuda.synchronize()
    out["fit_ms_per_step"] = (time.perf_counter() - t1) * 1e3 / steps
    launches["legacy_fit"] = read_launches(counters)
    check_counts("legacy fit", launches["legacy_fit"], fit_launches(steps))
    moved, changed = params_moved(torch, model, before)
    if not (all(math.isfinite(x) for x in losses) and moved > 0.0) or changed:
        raise AssertionError(f"legacy fit: losses {losses}, pi_head moved {moved}, other "
                             f"params changed: {changed}")
    out["fit"] = {"steps": steps, "epoch_losses": losses, "pi_head_abs_delta": moved,
                  "sample_bytes": sum(t.numel() * t.element_size()
                                      for t in _leaves(buf.data)) // buf.capacity}
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def device_launches(torch, fn, calls=3):
    """CUDA kernels launched per call of `fn` (every kernel, the library's
    too), counted by torch.profiler; "not measured" when it traces none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / calls if n else "not measured"


def default_loop(torch, tmap, counters, plain_versions, kernel_versions):
    """Phase 12: the closed loop with the JAX CLI's eval defaults at the
    bench configuration: Runner.eval on legacy tokens with the PDM-Lite ego
    (its waypoints computed every tick) and 2 walkers and 2 static
    obstacles per scenario, one chunk of K=40 ticks, exact launch counts;
    its env-steps/s (and the world's alone with the PDM ego) as phase 9
    times them; the kernels launched per env step with the PDM ego and the
    rule ego; and one f32 chunk through the kernels against the plain
    versions at phase 9's bounds."""
    from rift_tpu_torch.models.pluto import PlutoModel
    from rift_tpu_torch.rollout import ego_waypoints, rollout_chunk
    from rift_tpu_torch.runner import Runner, RunnerConfig
    from rift_tpu_torch.scenario import env_step
    from rift_tpu_torch.sim.state import CLASS_STATIC, CLASS_WALKER

    t0 = time.perf_counter()
    cfg = RunnerConfig(num_scenarios=S, num_agents=A, max_cbvs=C, max_episode_ticks=CHUNK,
                       ego="pdm", num_walkers=2, num_statics=2)
    runner = Runner(tmap, cfg)
    out, launches = {}, {}
    zero_launches(counters)
    t1 = time.perf_counter()
    stats = runner.eval(num_episodes=1, chunk=CHUNK)
    torch.cuda.synchronize()
    out["runner_eval_s"] = time.perf_counter() - t1
    launches["pdm_loop_eval"] = read_launches(counters)
    check_counts("Runner.eval (pdm, legacy)", launches["pdm_loop_eval"],
                 act_launches(CHUNK, legacy=True))
    recs = runner.stats.records
    promoted = sum(r.cbv_count for r in recs)
    if stats.total_routes != S or promoted == 0 or not all(
            math.isfinite(r.driving_score) for r in recs):
        raise AssertionError(f"Runner.eval (pdm): {stats.total_routes} routes, {promoted} "
                             "CBVs promoted, or non-finite driving scores")
    out["eval_stats"] = {"avg_driving_score": stats.avg_driving_score,
                         "avg_route_completion": stats.avg_route_completion,
                         "cbvs_promoted": promoted}

    state0, crit0, spec = runner.env.reset()
    cls = state0.agent_class
    if not (bool(((cls == CLASS_WALKER).sum(1) == 2).all())
            and bool(((cls == CLASS_STATIC).sum(1) == 2).all())):
        raise AssertionError("the PDM loop's scenes lack 2 walkers and 2 statics each")

    def steps_per_s(**kw):
        run = lambda s, c: rollout_chunk(runner.model, tmap, spec, s, c, max_cbvs=C,
                                         num_steps=CHUNK, ego="pdm", tick=0, **kw)
        run(state0, crit0)
        best = math.inf
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run(state0, crit0)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t1)
        return CHUNK * S / best

    out["eval_env_steps_per_s"] = steps_per_s()
    out["world_only_env_steps_per_s"] = steps_per_s(with_policy=False)
    tick = iter(range(1, 10**6))
    step = lambda ego: env_step(tmap, spec, state0, crit0, max_cbvs=C, tick=next(tick),
                                ego_traj=ego_waypoints(ego, tmap, spec, state0))
    out["device_launches_per_env_step"] = {
        "pdm": device_launches(torch, lambda: step("pdm")),
        "rule": device_launches(torch, lambda: step("rule")),
        "pdm_ego_waypoints_alone": device_launches(
            torch, lambda: ego_waypoints("pdm", tmap, spec, state0)),
    }

    model32 = PlutoModel(encoder_depth=cfg.encoder_depth, decoder_depth=cfg.decoder_depth,
                         dtype=torch.float32).eval()
    model32.load_state_dict(runner.model.state_dict())

    f32_tick = lambda s, c, k: rollout_chunk(model32, tmap, spec, s, c, max_cbvs=C,
                                             num_steps=1, ego="pdm", tick=k)[:2]
    out.update(f32_loop_apart(torch, f32_tick, state0, crit0, plain_versions, kernel_versions,
                              "f32 PDM loop"))
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def default_cli(torch, counters):
    """Phase 13: the CLI with the JAX CLI's defaults and no override (the
    pdm_lite ego, Pluto on legacy tokens, in eval 2 walkers and 2 statics)
    at the bench configuration: one eval episode of 40 ticks, then one
    train_cbv episode of 160 ticks (its fit rounds, each on a full
    4096-sample buffer, recorded: CBVs are recognised from tick 26 on)."""
    import os
    import shutil

    from rift_tpu_torch import run

    t0 = time.perf_counter()
    out, launches = {}, {}
    cli_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_cli_defaults")
    shutil.rmtree(cli_dir, ignore_errors=True)
    common = ["--cbv_cfg", "rift_pluto", "--num_scenario", str(S), "--num_agents", str(A),
              "--blocks", "2", "--num_episodes", "1", "--out_dir", cli_dir]
    zero_launches(counters)
    t1 = time.perf_counter()
    g = run.main(["--mode", "eval", "--max_ticks", str(CHUNK), *common])
    torch.cuda.synchronize()
    out["cli_eval_s"] = time.perf_counter() - t1
    launches["cli_defaults_eval"] = read_launches(counters)
    check_counts("CLI eval defaults", launches["cli_defaults_eval"],
                 act_launches(CHUNK, legacy=True))
    results = os.path.join(cli_dir, "eval", "pdm_lite-rift_pluto-seed0",
                           "simulation_results.json")
    if g.total_routes != S or not os.path.exists(results):
        raise AssertionError(f"CLI eval defaults: {g.total_routes} routes, results written: "
                             f"{os.path.exists(results)}")
    out["cli_eval"] = {"avg_driving_score": g.avg_driving_score,
                       "avg_route_completion": g.avg_route_completion}
    zero_launches(counters)
    t1 = time.perf_counter()
    g = run.main(["--mode", "train_cbv", "--max_ticks", "160", *common])
    torch.cuda.synchronize()
    out["cli_train_cbv_s"] = time.perf_counter() - t1
    launches["cli_defaults_train_cbv"] = read_launches(counters)
    ckpt = os.path.join(cli_dir, "train_cbv", "pdm_lite-rift_pluto-seed0", "model_ckpt")
    acts = launches["cli_defaults_train_cbv"]["retrack_rollout"]
    if g.total_routes != S or acts == 0 or not math.isfinite(g.avg_driving_score):
        raise AssertionError(f"CLI train_cbv defaults: {g.total_routes} routes, {acts} train "
                             f"acts, driving score {g.avg_driving_score}")
    out["cli_train_cbv"] = {"train_acts": acts, "avg_driving_score": g.avg_driving_score,
                            "checkpoints": sorted(os.listdir(ckpt)) if os.path.isdir(ckpt)
                            else []}
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def write_route_file(path, groups=ROUTE_GROUPS):
    """A route file in the Bench2Drive schema, written here (the repository
    ships none): `groups` copies, 3 km apart, of a straight route, an L
    with one corner (a junction in the route town) and a crossing pair
    (within 100 m of each other, so the data loader batches them apart; a
    shared junction in the shared town), each with weather keyframes at 0
    and 100 % of the route. Ids run 1, 2, ... in that order."""
    routes, rid = [], 0
    for g in range(groups):
        x0 = 3000.0 * g
        shapes = (
            [(x0 + 40.0 * i, 0.0) for i in range(6)],  # straight, 200 m
            [(x0, 400.0), (x0 + 150.0, 400.0), (x0 + 150.0, 480.0)],  # L
            [(x0 + 40.0 * i, 900.0) for i in range(7)],  # crossing, east
            [(x0 + 120.0, 800.0 + 40.0 * i) for i in range(6)],  # crossing, north
        )
        for k, pts in enumerate(shapes):
            rid += 1
            fog, rain = (20 * k, 10 * g)
            wps = "".join(f'<position x="{x}" y="{y}" z="0.0"/>' for x, y in pts)
            routes.append(
                f'<route id="{rid}" town="Town{12 + g % 2}"><weathers>'
                f'<weather route_percentage="0" cloudiness="10.0" precipitation="0.0" '
                f'fog_density="{fog}"/><weather route_percentage="100" cloudiness="80.0" '
                f'precipitation="{rain}" fog_density="{fog}"/></weathers>'
                f"<waypoints>{wps}</waypoints></route>")
    with open(path, "w") as f:
        f.write("<routes>\n" + "\n".join(routes) + "\n</routes>\n")
    return path


def ptxas_usage(log):
    """{kernel: [registers, spill store bytes, spill load bytes]} of each
    __global__ function in an nvcc -Xptxas -v log, by its demangled name
    (without its parameter list) where c++filt is on the machine."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [0, 0, 0]
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn][0] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
    except OSError:
        names = []
    if len(names) != len(out):
        names = list(out)
    short = lambda n: re.sub(r"^void |\(anonymous namespace\)::|\(.*\)$", "", n)
    return {short(n): v for n, v in zip(names, out.values())}


def recog_ticks(tick, n):
    """Env steps among ticks tick .. tick+n-1 that run recognition."""
    from rift_tpu_torch.scenario.recognition import RECOG_INTERVAL, RECOG_WARMUP_TICKS

    return sum(1 for t in range(tick + 1, tick + n + 1)
               if t > RECOG_WARMUP_TICKS and t % RECOG_INTERVAL == 0)


def route_launches(n_ticks, tick=0, with_policy=True):
    """Kernel launches of n ticks of the route eval from `tick`: the PlanT
    ego's 8 attention launches every tick, the recognizer's 4 on each
    recognition tick, and with the Pluto CBVs on legacy tokens their act's
    (17 attention, 1 whole encoder, 2 PointNet)."""
    want = act_launches(n_ticks if with_policy else 0, legacy=True)
    want["fused_attention"] += (PLANT_EGO["num_layers"] * n_ticks
                                + PLANT_RECOG["num_layers"] * recog_ticks(tick, n_ticks))
    return want


def plant_models(torch):
    """PlanT_medium as the ego and the recognizer, from seeded CPU
    generators, on the card, f32, without gradients."""
    from rift_tpu_torch.models.plant import PlanTModel, init_plant_weights

    make = lambda dims, seed: init_plant_weights(
        PlanTModel(**dims), torch.Generator().manual_seed(seed)
    ).to("cuda").eval().requires_grad_(False)
    return make(PLANT_EGO, 0), make(PLANT_RECOG, 1)


def route_path(torch, counters, route_file, plain_versions, kernel_versions):
    """Phase 14: this slice's main path. The route file's first batch of
    the Eval data loader (every route that overlaps none before it:
    straight, L and one of each crossing pair) becomes one route town on
    the card (map_from_routes, the CLI's 256-lane pad and stop ratio);
    shared_map_from_routes builds the town of all routes. TrafficEnv.reset
    puts each scenario on its route; then rollout_chunk with the PlanT_medium
    ego (f32), the default Pluto CBVs on legacy tokens (phase 4's width,
    bf16) and attention recognition, two K=40 chunks with exact launch
    counts; env-steps/s as phase 12 times them (and the world's alone with
    the PlanT ego); one f32 chunk through the kernels and the plain
    versions at phase 9's bounds, the PlanT egos apart at the CBVs'. Before
    the chunks, the attention kernel against its plain version at PlanT's
    shapes at the batch's n scenarios and at the CLI's 4."""
    from rift_tpu_torch.map import route_waypoints
    from rift_tpu_torch.map.from_route import map_from_routes, shared_map_from_routes
    from rift_tpu_torch.models.pluto import PlutoModel
    from rift_tpu_torch.ops import attention
    from rift_tpu_torch.rollout import rollout_chunk
    from rift_tpu_torch.scenario import TrafficEnv
    from rift_tpu_torch.scenario.routes import EvalDataLoader, parse_routes_file

    t0 = time.perf_counter()
    out, launches = {}, {}
    cfgs = parse_routes_file(route_file)
    batch = EvalDataLoader(cfgs, S).sampler()
    n = len(batch)
    t1 = time.perf_counter()
    tmap, paths = map_from_routes([c.keypoints for c in batch], num_lanes=2, pad_lanes_to=256,
                                  stop_ratio=0.25)
    out["route_town_s"] = time.perf_counter() - t1
    tmap = tmap.replace(light_group=torch.full_like(tmap.light_group, -1))
    t1 = time.perf_counter()
    shared, shared_paths = shared_map_from_routes([c.keypoints for c in cfgs], num_lanes=2,
                                                  stop_ratio=0.25)
    out["shared_town_s"] = time.perf_counter() - t1
    out["route_town"] = {"routes": n, "lanes": int(tmap.valid.sum()), "pad": tmap.num_lanes,
                         "junction_lanes": int(tmap.is_junction.sum()),
                         "stop_lanes": int(tmap.stop_lane.sum()),
                         "grid_cell_m": 1.0 / float(tmap.grid_inv_cell)}
    out["shared_town"] = {"routes": len(cfgs), "lanes": int(shared.valid.sum()),
                          "pad": shared.num_lanes,
                          "junction_lanes": int(shared.is_junction.sum())}
    if (tmap.device.type != "cuda" or shared.device.type != "cuda" or len(paths) != n
            or not all(len(p) >= 3 for p in paths + shared_paths)
            or not bool(tmap.is_junction.any()) or not bool(tmap.stop_lane.any())):
        raise AssertionError(f"route towns: {out['route_town']}, {out['shared_town']}")

    # the kernel against its plain version at PlanT's shapes at this batch's
    # n scenarios and at the CLI's default 4, f32 (1e-5) and bf16 (2e-2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    err = attention_errors(torch, attention, gen, [
        shape for b in sorted({n, 4}) for shape in plant_attention_shapes(b).values()])
    out["plant_attention_at_batch"] = {"batches": sorted({n, 4}), "max_abs_err": err["float32"],
                                       "max_abs_err_bf16": err["bfloat16"]}

    env = TrafficEnv(tmap, num_scenarios=n, num_agents=A, max_cbvs=C, seed=0)
    state0, crit0, spec = env.reset(routes=[route_waypoints(tmap, p) for p in paths],
                                    lane_paths=paths)
    torch.manual_seed(0)
    pluto = PlutoModel(encoder_depth=4, decoder_depth=4).eval()
    ego, recog = plant_models(torch)
    run = lambda s, c, tick, **kw: rollout_chunk(
        pluto, tmap, spec, s, c, max_cbvs=C, num_steps=CHUNK, ego="plant", ego_model=ego,
        recog_model=recog, tick=tick, **kw)[:2]

    s, c = state0, crit0
    for k in range(2):
        zero_launches(counters)
        s, c = run(s, c, k * CHUNK)
        torch.cuda.synchronize()
        path = f"route_plant_eval_{k}"
        launches[path] = read_launches(counters)
        check_counts(path, launches[path], route_launches(CHUNK, k * CHUNK))
    promoted = int(s.is_cbv.sum())
    if not torch.isfinite(s.pos).all() or promoted == 0:
        raise AssertionError(f"route eval: non-finite positions or no CBV ({promoted})")
    out["scenarios"], out["cbvs_after_two_chunks"] = n, promoted

    def steps_per_s(**kw):
        run(state0, crit0, 0, **kw)
        best = math.inf
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run(state0, crit0, 0, **kw)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t1)
        return CHUNK * n / best

    out["eval_env_steps_per_s"] = steps_per_s()
    out["world_only_env_steps_per_s"] = steps_per_s(with_policy=False)
    model32 = PlutoModel(encoder_depth=4, decoder_depth=4, dtype=torch.float32).eval()
    model32.load_state_dict(pluto.state_dict())
    f32_tick = lambda s, c, k: rollout_chunk(
        model32, tmap, spec, s, c, max_cbvs=C, num_steps=1, ego="plant", ego_model=ego,
        recog_model=recog, tick=k)[:2]
    out.update(f32_loop_apart(torch, f32_tick, state0, crit0, plain_versions, kernel_versions,
                              "f32 route loop", ego_on_kernels=True))
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def route_cli(torch, counters, route_file):
    """Phase 15: the CLI on the route file. `run.main` in eval with the
    PlanT_medium ego and attention recognition at the default num_scenario
    (4) over routes 1-5 (route 4 crosses 3, so the loader gives [1, 2, 3,
    5], then [4] padded to 4 scenarios): two episodes of 60 ticks, exact
    launch counts, records with the five route ids (the padded batch makes
    one) and their weather; `--shared_town` for one episode; and
    train_cbv on the routes at depth 1 with a 256-sample buffer until a
    fit round, which takes the re-tracking and reference-line kernels on
    route towns."""
    import os
    import shutil

    from rift_tpu_torch import run
    from rift_tpu_torch.scenario.routes import parse_routes_file

    t0 = time.perf_counter()
    out, launches = {}, {}
    cli_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_cli_routes")
    shutil.rmtree(cli_dir, ignore_errors=True)
    common = ["--routes", route_file, "--routes_subset", "1-5", "--out_dir", cli_dir]
    ticks = 60
    zero_launches(counters)
    t1 = time.perf_counter()
    g = run.main(["--mode", "eval", "--ego_cfg", "plant", "--cbv_recog", "attention",
                  "--num_episodes", "2", "--max_ticks", str(ticks), *common])
    torch.cuda.synchronize()
    out["cli_eval_s"] = time.perf_counter() - t1
    launches["cli_route_eval"] = read_launches(counters)
    check_counts("CLI route eval", launches["cli_route_eval"],
                 add(route_launches(ticks), route_launches(ticks)))
    cfgs = {c.name: c for c in parse_routes_file(route_file, "1-5")}
    with open(os.path.join(cli_dir, "eval", "plant-rift_pluto-seed0",
                           "simulation_results.json")) as f:
        records = json.load(f)["records"]
    ids = [r["route_id"] for r in records]
    weather_ok = all(r["weather"] and r["weather"] == cfgs[r["route_id"]].weather.at(
        r["route_completion"]) for r in records)
    if g.total_routes != 5 or sorted(ids) != sorted(cfgs) or not weather_ok:
        raise AssertionError(f"CLI route eval: {g.total_routes} routes, ids {ids}, "
                             f"weather recorded: {weather_ok}")
    out["cli_eval"] = {"route_ids": ids, "avg_driving_score": g.avg_driving_score,
                       "avg_route_completion": g.avg_route_completion}

    t1 = time.perf_counter()
    g = run.main(["--mode", "eval", "--shared_town", "--ego_cfg", "plant",
                  "--num_episodes", "1", "--max_ticks", "20", *common])
    torch.cuda.synchronize()
    out["cli_shared_town_s"] = time.perf_counter() - t1
    if g.total_routes != 4:
        raise AssertionError(f"CLI --shared_town: {g.total_routes} routes")

    zero_launches(counters)
    t1 = time.perf_counter()
    g = run.main(["--mode", "train_cbv", "--ego_cfg", "behavior", "--routes", route_file,
                  "--num_scenario", "16", "--num_agents", str(A), "--num_episodes", "1",
                  "--max_ticks", "80", "--out_dir", cli_dir, "encoder_depth=1",
                  "decoder_depth=1", "buffer_capacity=256"])
    torch.cuda.synchronize()
    out["cli_train_cbv_s"] = time.perf_counter() - t1
    launches["cli_route_train_cbv"] = read_launches(counters)
    ckpt = os.path.join(cli_dir, "train_cbv", "behavior-rift_pluto-seed0", "model_ckpt")
    got = launches["cli_route_train_cbv"]
    fitted = os.path.isdir(ckpt) and os.listdir(ckpt)
    if not (got["retrack_rollout"] > 0 and got["refline_matrices"] > 0 and fitted
            and math.isfinite(g.avg_driving_score)):
        raise AssertionError(f"CLI route train_cbv: launches {got}, checkpoints {fitted}")
    out["cli_train_cbv"] = {"routes": g.total_routes, "checkpoints": sorted(os.listdir(ckpt))}
    out["seconds"] = time.perf_counter() - t0
    return out, launches


@contextlib.contextmanager
def recording(registry, key, snapshot):
    """registry[key] (a policy zoo of run.py) replaced by a subclass that
    records each instance it makes with `snapshot(instance)` of its
    weights as built, and every loss of its `train_round` (`.losses`)."""
    base, made = registry[key], []

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.losses = []
            made.append((self, snapshot(self)))

        def train_round(self, *a, **kw):
            losses = super().train_round(*a, **kw)
            self.losses.extend(losses)
            return losses

    registry[key] = Recorded
    try:
        yield made
    finally:
        registry[key] = base


def fields_apart(torch, a, b, prefix=""):
    """Names of the fields of two state dataclasses (nested ones too) that
    are not bit-equal (NaN equal to NaN)."""
    import dataclasses

    names = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            names += fields_apart(torch, x, y, f"{prefix}{f.name}.")
        elif x is not None and not (x.shape == y.shape and bool(
                ((x == y) | ((x != x) & (y != y))).all())):
            names.append(prefix + f.name)
    return names


def fake_pluto_state_dict(dim=DIM, enc_depth=4, dec_depth=4):
    """A reference PlanningModel state dict (pluto_model.py and its modules:
    the key names and shapes of tests/test_convert.py's
    fake_reference_state_dict), numpy only, each tensor seeded by its key."""
    import zlib

    import numpy as np

    sd = {}
    rng = lambda key: np.random.default_rng(zlib.crc32(key.encode()))
    normal = lambda key, shape, scale: rng(key).normal(size=shape, scale=scale).astype(np.float32)

    def linear(key, cin, cout, scale=0.02):
        sd[f"{key}.weight"] = normal(key, (cout, cin), scale)
        sd[f"{key}.bias"] = np.zeros(cout, np.float32)

    def ln(key, d):
        sd[f"{key}.weight"] = np.ones(d, np.float32)
        sd[f"{key}.bias"] = np.zeros(d, np.float32)

    def bn(key, d):
        ln(key, d)
        sd[f"{key}.running_mean"] = normal(key, d, 0.1)
        sd[f"{key}.running_var"] = np.ones(d, np.float32)
        sd[f"{key}.num_batches_tracked"] = np.asarray(1)

    def fourier(key, c, f=64):
        sd[f"{key}.freqs.weight"] = normal(key, (c, f), 1.0)
        for i in range(c):
            linear(f"{key}.mlps.{i}.0", 2 * f + 1, dim)
            ln(f"{key}.mlps.{i}.1", dim)
            linear(f"{key}.mlps.{i}.3", dim, dim)
        ln(f"{key}.to_out.0", dim)
        linear(f"{key}.to_out.2", dim, dim)

    def mlp_layer(key, cin, hidden, cout):
        linear(f"{key}.mlp.0", cin, hidden)
        ln(f"{key}.mlp.1", hidden)
        linear(f"{key}.mlp.3", hidden, cout)

    def points_encoder(key, cin):
        linear(f"{key}.first_mlp.0", cin, 128)
        bn(f"{key}.first_mlp.1", 128)
        linear(f"{key}.first_mlp.3", 128, 256)
        linear(f"{key}.second_mlp.0", 512, 256)
        bn(f"{key}.second_mlp.1", 256)
        linear(f"{key}.second_mlp.3", 256, dim)

    def mha(key, d=dim):
        sd[f"{key}.in_proj_weight"] = normal(key + ".in", (3 * d, d), 0.02)
        sd[f"{key}.in_proj_bias"] = np.zeros(3 * d, np.float32)
        linear(f"{key}.out_proj", d, d)

    def conv(key, cin, cout, bias=True):
        sd[f"{key}.weight"] = normal(key, (cout, cin, 3), 0.05)
        if bias:
            sd[f"{key}.bias"] = np.zeros(cout, np.float32)

    hist = "agent_encoder.history_encoder"
    fourier("pos_emb", 3)
    conv(f"{hist}.embed.proj", 9, 32)
    for level, (c, heads, k) in enumerate(((32, 2, 3), (64, 4, 3), (128, 8, 5))):
        for i in range(2):
            key = f"{hist}.levels.{level}.blocks.{i}"
            ln(f"{key}.norm1", c)
            sd[f"{key}.attn.qkv.weight"] = normal(key + ".qkv", (3 * c, c), 0.02)
            sd[f"{key}.attn.qkv.bias"] = np.zeros(3 * c, np.float32)
            sd[f"{key}.attn.rpb"] = normal(key + ".rpb", (heads, 2 * k - 1), 0.02)
            linear(f"{key}.attn.proj", c, c)
            ln(f"{key}.norm2", c)
            linear(f"{key}.mlp.fc1", c, 3 * c)
            linear(f"{key}.mlp.fc2", 3 * c, c)
        ln(f"{hist}.norm{level}", c)
        if level < 2:
            conv(f"{hist}.levels.{level}.downsample.reduction", c, 2 * c, bias=False)
            ln(f"{hist}.levels.{level}.downsample.norm", 2 * c)
    for j, d in enumerate((32, 64, 128)):
        conv(f"{hist}.lateral_convs.{j}", d, 128)
    conv(f"{hist}.fpn_conv", 128, 128)
    for i in range(6):
        linear(f"agent_encoder.ego_state_emb.linears.{i}", 1, dim)
    mha("agent_encoder.ego_state_emb.attn")
    for key, shape, scale in (
        ("agent_encoder.ego_state_emb.pos_embed", (1, 6, dim), 0.02),
        ("agent_encoder.ego_state_emb.query", (1, 1, dim), 0.02),
        ("agent_encoder.type_emb.weight", (4, dim), 0.02),
        ("map_encoder.type_emb.weight", (3, dim), 0.02),
        ("map_encoder.on_route_emb.weight", (2, dim), 0.02),
        ("map_encoder.traffic_light_emb.weight", (4, dim), 0.02),
        ("map_encoder.unknown_speed_emb.weight", (1, dim), 0.02),
        ("static_objects_encoder.type_emb.weight", (4, dim), 0.01),
        ("planning_decoder.m_emb", (1, 1, MODES, dim), 0.01),
        ("planning_decoder.m_pos", (1, MODES, dim), 0.01),
    ):
        sd[key] = normal(key, shape, scale)
    points_encoder("map_encoder.polygon_encoder", 10)
    fourier("map_encoder.speed_limit_emb", 1)
    fourier("static_objects_encoder.obj_encoder", 2)
    for i in range(enc_depth):
        ln(f"encoder_blocks.{i}.norm1", dim)
        mha(f"encoder_blocks.{i}.attn")
        ln(f"encoder_blocks.{i}.norm2", dim)
        linear(f"encoder_blocks.{i}.mlp.fc1", dim, 4 * dim)
        linear(f"encoder_blocks.{i}.mlp.fc2", 4 * dim, dim)
    ln("norm", dim)
    for name in ("loc", "yaw", "vel"):
        mlp_layer(f"agent_predictor.{name}_predictor", dim, 2 * dim, 160)
    fourier("planning_decoder.r_pos_emb", 3)
    points_encoder("planning_decoder.r_encoder", 6)
    linear("planning_decoder.q_proj", 2 * dim, dim)
    linear("planning_decoder.cat_x_proj", 2 * dim, dim)
    for i in range(dec_depth):
        key = f"planning_decoder.decoder_blocks.{i}"
        for n in range(1, 5):
            ln(f"{key}.norm{n}", dim)
        for attn in ("r2r_attn", "m2m_attn", "cross_attn"):
            mha(f"{key}.{attn}")
        linear(f"{key}.ffn.0", dim, 4 * dim)
        linear(f"{key}.ffn.3", 4 * dim, dim)
    for name in ("loc", "yaw", "vel"):
        mlp_layer(f"planning_decoder.{name}_head", dim, 2 * dim, 160)
    mlp_layer("planning_decoder.pi_head", dim, dim, 1)
    linear("hidden_proj.0", dim, dim)
    linear("hidden_proj.2", dim, dim)
    mlp_layer("ref_free_decoder", dim, 2 * dim, 320)
    return sd


def per_tick_path(torch, tmap, counters):
    """Phase 16: the per-tick loop (run.run_episode), raw controls, classic
    PPO and train_ego at the bench configuration, legacy tokens and the JAX
    CLI's defaults: (a) 40 ticks of the per-tick loop and 40 of the fused
    one from one reset (pdm_lite, rift_pluto in eval, 2 walkers and 2
    statics), every SimState and criteria field bit-equal, exact launch
    counts, both loops' env-steps/s (best of two, in turns); (b) `run.main --mode train_cbv
    --no_fused` to one fit round (a re-tracking and a reference-line launch
    every tick, finite losses, pi_head moved and nothing else); (c) `--mode
    train_ego --ego_cfg ppo` with the rift_pluto CBVs on their train act
    every tick (finite ego losses, ego weights moved); (d) `--mode
    train_cbv --cbv_cfg ppo`, then `frea` (its warning): finite losses,
    weights moved, no hand-kernel launch; (e) `--mode eval --ego_cfg
    expert_disturb`, per tick, with its driving score."""
    import io
    import os
    import shutil
    import warnings

    from rift_tpu_torch import policies, run
    from rift_tpu_torch.scenario import TrafficEnv
    from rift_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    out, launches = {}, {}
    env = TrafficEnv(tmap, num_scenarios=S, num_agents=A, max_cbvs=2, num_walkers=2,
                     num_statics=2)
    ego = policies.PDMLiteEgo(tmap)
    cbv = policies.RIFTPlutoPolicy(tmap, {**load_config("rift_pluto"), "max_cbvs": 2})
    state0, crit0, spec = env.reset()

    def loop(fn):
        env.tick = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fn(env, ego, cbv, state0, crit0, spec, CHUNK)
        torch.cuda.synchronize()
        return res, CHUNK * S / (time.perf_counter() - t1)

    loop(run.run_episode_fused)  # warm-up
    zero_launches(counters)
    (st, cr), rate = loop(run.run_episode)
    launches["per_tick_eval"] = read_launches(counters)
    check_counts("per-tick eval", launches["per_tick_eval"], act_launches(CHUNK, legacy=True))
    (fst, fcr), fused_rate = loop(run.run_episode_fused)
    # env-steps/s: the best of two runs of each loop, in turns
    out["per_tick_env_steps_per_s"] = max(rate, loop(run.run_episode)[1])
    out["fused_env_steps_per_s"] = max(fused_rate, loop(run.run_episode_fused)[1])
    apart = fields_apart(torch, st, fst) + fields_apart(torch, cr, fcr, "crit.")
    out["per_tick_vs_fused_fields_apart"] = apart
    out["cbvs_at_the_end"] = int(st.is_cbv.sum())
    if not out["cbvs_at_the_end"]:
        raise AssertionError("per-tick eval: no CBV by tick 40")
    if apart:
        # bounded only if the fused loop is itself not reproducible
        (fst2, fcr2), _ = loop(run.run_episode_fused)
        again = fields_apart(torch, fst, fst2) + fields_apart(torch, fcr, fcr2, "crit.")
        moved = torch.linalg.norm(st.pos - fst.pos, dim=-1) > 1e-2
        moved |= st.is_cbv != fst.is_cbv
        out["fused_vs_fused_fields_apart"] = again
        out["per_tick_vs_fused_agents_apart_share"] = moved.float().mean().item()
        if not again or out["per_tick_vs_fused_agents_apart_share"] > LOOP_AGENTS_APART:
            raise AssertionError(f"per-tick vs fused: fields {apart} differ; the fused loop "
                                 f"against itself: {again}")
    del env, ego, cbv

    cli_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_cli_per_tick")
    shutil.rmtree(cli_dir, ignore_errors=True)
    common = ["--num_scenario", str(S), "--num_agents", str(A), "--blocks", "2",
              "--num_episodes", "1", "--out_dir", cli_dir]
    pluto_w = lambda p: {n: t.detach().clone() for n, t in p.model.named_parameters()}
    ppo_w = lambda p: [t.detach().clone() for t in p.ppo.parameters()]
    ppo_moved = lambda p, before: sum(
        (t.detach() - b).abs().sum().item() for t, b in zip(p.ppo.parameters(), before))

    def cli(path, argv, registry, key, snapshot):
        zero_launches(counters)
        t1 = time.perf_counter()
        with recording(registry, key, snapshot) as made, \
                contextlib.redirect_stdout(io.StringIO()) as o:
            g = run.main(argv)
        torch.cuda.synchronize()
        out[f"{path}_s"] = time.perf_counter() - t1
        launches[path] = read_launches(counters)
        if g.total_routes != S or not math.isfinite(g.avg_driving_score):
            raise AssertionError(f"{path}: {g.total_routes} routes, driving score "
                                 f"{g.avg_driving_score}")
        return made[0], o.getvalue()

    # (b) per-tick train_cbv to one fit round
    ticks = 2 * CHUNK
    (pol, before), _ = cli("cli_per_tick_train_cbv",
                           ["--mode", "train_cbv", "--no_fused", "--max_ticks", str(ticks),
                            *common, f"buffer_capacity={PER_TICK_BUFFER}"],
                           run.CBV_POLICY_LIST, "rift_pluto", pluto_w)
    steps = pol.train_rounds * pol.train_cfg.epochs * (
        PER_TICK_BUFFER // pol.train_cfg.batch_size)
    check_counts("CLI per-tick train_cbv", launches["cli_per_tick_train_cbv"],
                 add(act_launches(ticks, train=True, legacy=True), fit_launches(steps)))
    moved, changed = params_moved(torch, pol.model, before)
    if not (pol.train_rounds == 1 and pol.losses and all(map(math.isfinite, pol.losses))
            and moved > 0 and not changed):
        raise AssertionError(f"CLI per-tick train_cbv: {pol.train_rounds} rounds, losses "
                             f"{pol.losses}, pi_head moved {moved}, others changed {changed}")
    out["cli_per_tick_train_cbv"] = {"losses": pol.losses, "pi_head_abs_delta": moved}

    # (c) train_ego: the PPO ego; the default rift_pluto CBVs act in train mode
    ticks = CHUNK
    (ego, before), _ = cli("cli_train_ego",
                           ["--mode", "train_ego", "--ego_cfg", "ppo", "--max_ticks",
                            str(ticks), *common], run.EGO_POLICY_LIST, "ppo", ppo_w)
    check_counts("CLI train_ego", launches["cli_train_ego"],
                 act_launches(ticks, train=True, legacy=True))
    delta = ppo_moved(ego, before)
    if not (ego.losses and all(map(math.isfinite, ego.losses)) and delta > 0):
        raise AssertionError(f"CLI train_ego: losses {ego.losses}, ego moved {delta}")
    out["cli_train_ego"] = {"losses": ego.losses, "ego_abs_delta": delta}

    # (d) the classic PPO CBVs: raw controls, no hand kernel on the path
    for key in ("ppo", "frea"):
        path = f"cli_classic_{key}"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (pol, before), _ = cli(path, ["--mode", "train_cbv", "--cbv_cfg", key,
                                          "--max_ticks", str(CHUNK), *common],
                                   run.CBV_POLICY_LIST, key, ppo_w)
        check_counts(path, launches[path], act_launches(0))
        delta = ppo_moved(pol, before)
        warned = any("frea" in str(w.message) for w in caught)
        if not (pol.losses and all(map(math.isfinite, pol.losses)) and delta > 0
                and warned == (key == "frea")):
            raise AssertionError(f"{path}: losses {pol.losses}, moved {delta}, warned {warned}")
        out[path] = {"losses": pol.losses, "abs_delta": delta}

    # (e) eval with the expert_disturb ego, which only the per-tick loop runs
    _, text = cli("cli_expert_disturb_eval", ["--mode", "eval", "--ego_cfg", "expert_disturb",
                                              "--max_ticks", str(CHUNK), *common],
                  run.EGO_POLICY_LIST, "expert_disturb", lambda p: None)
    check_counts("CLI expert_disturb eval", launches["cli_expert_disturb_eval"],
                 act_launches(CHUNK, legacy=True))
    ds = [line for line in text.splitlines() if line.startswith("episode 0: DS=")]
    if not ds:
        raise AssertionError("CLI expert_disturb eval printed no driving score")
    out["cli_expert_disturb_eval"] = ds[0]
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def fit_recorder(torch, model):
    """Hooks that record a fit's every forward's waypoints and the first
    optimizer step's gradients: (records, remove)."""
    rec = {"pred_wp": [], "grads": None}
    fwd = model.register_forward_hook(
        lambda mod, args, out: rec["pred_wp"].append(out["pred_wp"].detach().clone()))

    def first_grads(opt, args, kwargs):
        if rec["grads"] is None:
            rec["grads"] = [p.grad.detach().clone() for g in opt.param_groups
                            for p in g["params"]]

    from torch.optim.optimizer import register_optimizer_step_pre_hook

    step = register_optimizer_step_pre_hook(first_grads)
    return rec, lambda: (fwd.remove(), step.remove())


def collect_and_plant(torch, tmap, counters, scenes, plain_versions, kernel_versions,
                      per_tick_rate):
    """Phase 17: (a) `run.collect_episode` at the bench configuration
    (pdm_lite, rift_pluto at full width on legacy tokens, collect's
    defaults: no walkers or statics, 3 CBVs) for 80 ticks into a
    CollectBuffer, exact launch counts, one frame a tick, the last frame
    the returned state's bits, env-steps/s beside phase 16's per-tick eval;
    (b) the frames stacked as `save` stacks them into PlanT's dataset on
    the card (12 sample ticks x 64 = 768 samples); (c) PlanT_medium's fit
    (f32, seeded weights, 1 epoch of 12 steps of 64): 8 attention launches
    a step and no other, finite losses, every parameter moved, against the
    same fit through the plain versions (the first step's gradients within
    1e-4, each step's loss within 1e-4 relative), ms per step of both;
    (d) the fitted weights through `save_plant_params` and a strict
    `load_plant_weights`: the same waypoints, bit for bit; (e) a Lightning
    checkpoint fabricated here through `load_pretrained_pluto` into a
    full-width `PlutoModel(points_norm="none")`: the PointNet without layer
    norms (`has_ln = 0`) against its plain version at the reference-line
    and legacy map-polygon shapes (1e-4, whole-masked rows exactly 0),
    timed with its bound; the legacy eval act on phase 3's scenes with
    exact launches; the f32 act through the kernels against the plain
    versions (1e-3); (f) `grpo_advantage` on one CBV against its row of
    `grpo_advantage_batched` (one re-tracking and one reference-line
    launch), a train act with `adv_debug` against one without (advantages
    and returns bit for bit, finite `dbg_*`), `init_sim_state` on CUDA."""
    import copy
    import dataclasses
    import os

    import numpy as np

    from rift_tpu_torch import policies, run
    from rift_tpu_torch.models.plant import PlanTModel, init_plant_weights, plant_ego_waypoints
    from rift_tpu_torch.models.plant.train import (
        fit_plant,
        load_plant_weights,
        plant_bc_dataset,
        save_plant_params,
    )
    from rift_tpu_torch.models.pluto import PlutoModel, build_cbv_features, pluto_cbv_act
    from rift_tpu_torch.models.pluto.convert import load_pretrained_pluto
    from rift_tpu_torch.models.pluto.policy import _neighbor_states
    from rift_tpu_torch.ops import points
    from rift_tpu_torch.rl import control_to_rl_action, evaluator
    from rift_tpu_torch.rl.collect import CollectBuffer
    from rift_tpu_torch.scenario import TrafficEnv, cbv_slot_assignment
    from rift_tpu_torch.sim import init_sim_state
    from rift_tpu_torch.utils.config import load_config
    from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params

    t0 = time.perf_counter()
    out, launches = {}, {}
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_collect")
    os.makedirs(work, exist_ok=True)

    # (a) collect
    ticks = 2 * CHUNK
    env = TrafficEnv(tmap, num_scenarios=S, num_agents=A, max_cbvs=C)
    ego = policies.PDMLiteEgo(tmap)
    cbv = policies.RIFTPlutoPolicy(tmap, {**load_config("rift_pluto"), "max_cbvs": C})
    state0, crit0, spec = env.reset()
    env.tick = 0
    run.collect_episode(env, ego, cbv, state0, crit0, spec, 5, CollectBuffer(work))  # warm-up
    buf = CollectBuffer(work, ego.name, cbv.name)
    env.tick = 0
    zero_launches(counters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, crit = run.collect_episode(env, ego, cbv, state0, crit0, spec, ticks, buf)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches["collect"] = read_launches(counters)
    n = len(buf.frames)
    if not (n == env.tick == ticks):
        raise AssertionError(f"collect: {n} frames in {env.tick} ticks, expected {ticks}")
    check_counts("collect", launches["collect"], act_launches(ticks, legacy=True))
    last = buf.frames[-1]
    for k in last:
        v = (control_to_rl_action(state.control) if k == "rl_action"
             else getattr(state, k)).cpu().numpy()
        if not np.array_equal(last[k], v.astype(last[k].dtype)):
            raise AssertionError(f"collect: the last frame's {k} is not the returned state's")
    out["collect"] = {"ticks": ticks, "env_steps_per_s": S * ticks / seconds,
                      "per_tick_eval_env_steps_per_s_phase_16": per_tick_rate,
                      "cbvs_at_the_end": int(state.is_cbv.sum()), "seconds": seconds}

    # (b) PlanT's dataset on the card, from the frames as `save` stacks them
    data = {k: np.stack([fr[k] for fr in buf.frames]) for k in buf.frames[0]}
    data.update({f"static_{k}": v for k, v in buf._static.items()})
    dataset = plant_bc_dataset(data, pred_len=4, stride=5)
    samples = len(range(0, ticks - 4 * 5, 5)) * S
    if tuple(dataset[0].shape) != (samples, PLANT_TOKENS - 1, 7) or not all(
            torch.isfinite(x).all() for x in dataset):
        raise AssertionError(f"PlanT dataset: tokens {tuple(dataset[0].shape)}, expected "
                             f"({samples}, {PLANT_TOKENS - 1}, 7), or non-finite values")
    del env, ego, cbv

    # (c) PlanT_medium's fit, through the kernels and through the plain versions
    model = init_plant_weights(PlanTModel(**PLANT_EGO), torch.Generator().manual_seed(0))
    model.to("cuda")
    plain_model = copy.deepcopy(model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    steps = samples // 64
    # warm-up: one step each way on a copy (the backward's and AdamW's
    # first-use set-up stays out of the timed fits)
    first_batch = tuple(x[:64] for x in dataset)
    for warm in (kernel_versions, plain_versions):
        warm()
        try:
            fit_plant(copy.deepcopy(model), first_batch, epochs=1, batch_size=64)
        finally:
            kernel_versions()
    fits = {}
    for name, m in (("kernel", model), ("plain", plain_model)):
        rec, remove = fit_recorder(torch, m)
        zero_launches(counters)
        if name == "plain":
            plain_versions()
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, ep_losses = fit_plant(m, dataset, lr=1e-4, epochs=1, batch_size=64)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3 / steps
        finally:
            kernel_versions()
            remove()
        launches[f"plant_fit_{name}"] = read_launches(counters)
        order = np.random.default_rng(0).permutation(samples)
        step_losses = [
            (wp - dataset[3][torch.from_numpy(order[b * 64:(b + 1) * 64]).cuda()])
            .abs().mean().item() for b, wp in enumerate(rec["pred_wp"])]
        fits[name] = {"ms_per_step": ms, "step_losses": step_losses, "epoch_loss": ep_losses,
                      "grads": rec["grads"]}
    check_counts("PlanT fit", launches["plant_fit_kernel"], {
        **act_launches(0), "fused_attention": PLANT_EGO["num_layers"] * steps})
    launches["plant_fit"] = launches.pop("plant_fit_kernel")
    del launches["plant_fit_plain"]
    kl, pl = fits["kernel"]["step_losses"], fits["plain"]["step_losses"]
    if not (len(kl) == steps and all(map(math.isfinite, kl))):
        raise AssertionError(f"PlanT fit: losses {kl}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    grad_err = max((a - b).abs().max().item()
                   for a, b in zip(fits["kernel"]["grads"], fits["plain"]["grads"]))
    unmoved = [k for k, p in model.named_parameters() if torch.equal(p.detach(), before[k])]
    if not (loss_rel <= 1e-4 and grad_err <= 1e-4 and not unmoved):
        raise AssertionError(f"PlanT fit kernel vs plain: losses {loss_rel} relative, first "
                             f"gradients {grad_err}; parameters unmoved {unmoved}")
    out["plant_fit"] = {
        "steps": steps, "batch": 64, "ms_per_step": fits["kernel"]["ms_per_step"],
        "plain_ms_per_step": fits["plain"]["ms_per_step"], "step_losses": kl,
        "plain_step_losses": pl, "loss_max_rel_err": loss_rel,
        "first_step_grad_max_abs_err": grad_err,
    }

    # (d) the fitted weights through the npz
    npz = os.path.join(work, "plant_medium.npz")
    save_plant_params(model, npz)
    fresh = load_plant_weights(PlanTModel(**PLANT_EGO).to("cuda"), npz)
    wp, wp_fresh = (plant_ego_waypoints(m, spec, state) for m in (model, fresh))
    if not torch.equal(wp, wp_fresh):
        raise AssertionError("PlanT npz: the reloaded model's waypoints differ")
    out["plant_npz_waypoints"] = list(wp.shape)

    # (e) a Lightning checkpoint through the converter
    ckpt = os.path.join(work, "pluto_fabricated.ckpt")
    torch.save({"state_dict": {f"model.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in fake_pluto_state_dict().items()}}, ckpt)
    params, model_kw = load_pretrained_pluto(ckpt)
    flat = flatten_params(params)
    conv = PlutoModel(encoder_depth=4, decoder_depth=4, **model_kw).eval()
    load_jax_params(conv, flat)
    conv32 = PlutoModel(encoder_depth=4, decoder_depth=4, dtype=torch.float32,
                        **model_kw).eval()
    load_jax_params(conv32, flat)
    gen = torch.Generator(device="cuda").manual_seed(17)
    no_ln = {}
    for key, enc, (N, P, Cin, prefix) in (
            ("ref_lines", conv.planning_decoder.r_encoder, (S * C * REFS, POINTS, 6, True)),
            ("legacy_map", conv.MapEncoder_0.PointsEncoder_0, (LEGACY_MAP_ROWS, 20, 10, False))):
        if enc.has_ln:
            raise AssertionError(f"converted PointNet {key} has layer norms")
        x, mask, _ = points_inputs(torch, gen, N, P, Cin, prefix)
        out_rows = ~mask.any(-1)
        if key == "legacy_map":
            out_rows = torch.rand(N, generator=gen, device="cuda") < LEGACY_POLYGONS_OUT
            mask[out_rows] = False
        w = enc.weights()
        got = points.points_encoder(x, mask, w, DIM, has_ln=False)
        ref = points.points_forward_ref(x, mask, w, has_ln=False)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not (err <= 1e-4 and not got[out_rows].any()):
            raise AssertionError(f"PointNet has_ln=0 {key}: max err {err} > 1e-4, or a "
                                 "masked row not 0")
        wb = [t for i, t in enumerate(w) if i not in (2, 3, 8, 9)]  # no layer-norm reads
        bound, by = points_bound(x, mask, wb)
        no_ln[key] = {
            "ms": cuda_ms(torch, lambda: points.points_encoder(x, mask, w, DIM, has_ln=False)),
            "plain_ms": cuda_ms(torch, lambda: points.points_forward_ref(x, mask, w, False)),
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "timed_work": f"N={N}, P={P}, C={Cin}, {int(out_rows.sum())} rows masked whole, "
                          "f32, the converted weights",
        }
    out["points_no_ln"] = no_ln
    zero_launches(counters)
    for st, sp in scenes:
        act = pluto_cbv_act(conv, tmap, sp, st, max_cbvs=C)
        if not torch.isfinite(act["traj"]).all():
            raise AssertionError("converted model: non-finite waypoints")
    torch.cuda.synchronize()
    launches["converted_eval_act"] = read_launches(counters)
    check_counts("converted eval act", launches["converted_eval_act"],
                 act_launches(len(scenes), legacy=True))
    st, sp = scenes[0]
    got = pluto_cbv_act(conv32, tmap, sp, st, max_cbvs=C)
    plain_versions()
    try:
        ref = pluto_cbv_act(conv32, tmap, sp, st, max_cbvs=C)
    finally:
        kernel_versions()
    mask = ref["mask"]
    conv_err = (got["traj"][mask] - ref["traj"][mask]).abs().max().item()
    if not (torch.equal(got["mask"], mask) and conv_err <= 1e-3):
        raise AssertionError(f"converted f32 act: waypoints {conv_err} apart, or masks differ")
    out["converted_f32_traj_max_abs_err"] = conv_err

    # (f) the single-CBV evaluator, adv_debug, init_sim_state
    slots = cbv_slot_assignment(st.is_cbv, C)
    slot = torch.clamp(slots, min=0)
    scen = torch.arange(S, device="cuda")[:, None].expand(S, C)
    feats, _ = build_cbv_features(tmap, st, slots, sp)
    model_in = {g: {k: v.reshape((S * C,) + v.shape[2:]) for k, v in d.items()}
                if isinstance(d, dict) else d.reshape((S * C,) + d.shape[2:])
                for g, d in feats.items()}
    with torch.no_grad():
        traj = conv32({**model_in, "no_aux": True})["trajectory"]
    fb = lambda x: x.reshape((S * C,) + x.shape[2:])
    rl = feats["reference_line"]
    args = (traj.reshape(S * C, REFS, MODES, -1, 6), fb(rl["valid_mask"]).any(-1),
            fb(rl["position"]), fb(rl["orientation"]), fb(rl["valid_mask"]),
            fb(st.pos[scen, slot]), fb(st.heading[scen, slot]), fb(st.speed[scen, slot]),
            fb(st.shape[scen, slot]), *(fb(x) for x in _neighbor_states(st, scen, slot)))
    batched = evaluator.grpo_advantage_batched(tmap, *args)
    b = 5
    zero_launches(counters)
    one = evaluator.grpo_advantage(tmap, *(a[b] for a in args))
    torch.cuda.synchronize()
    launches["grpo_advantage_one"] = read_launches(counters)
    check_counts("grpo_advantage on one CBV", launches["grpo_advantage_one"],
                 {**act_launches(0), "retrack_rollout": 1, "refline_matrices": 1})
    if not torch.equal(one["valid_mask"], batched["valid_mask"][b]):
        raise AssertionError("grpo_advantage: the valid mask differs from the batched row")
    one_err = max((one[k] - batched[k][b]).abs().max().item()
                  for k in ("advantage", "rollout_return"))
    if not one_err <= 1e-5:
        raise AssertionError(f"grpo_advantage: {one_err} from the batched row")
    out["grpo_advantage_one_vs_batched_max_abs_err"] = one_err
    plain_act = pluto_cbv_act(conv, tmap, sp, st, max_cbvs=C, train=True)
    dbg = pluto_cbv_act(conv, tmap, sp, st, max_cbvs=C, train=True, adv_debug=True)
    dbg_keys = sorted(k for k in dbg if k.startswith("dbg_"))
    same = all(torch.equal(dbg[k], plain_act[k]) for k in ("advantage", "rollout_return",
                                                          "adv_valid"))
    if not (same and len(dbg_keys) == 11
            and all(torch.isfinite(dbg[k].float()).all() for k in dbg_keys)):
        raise AssertionError(f"adv_debug: advantages equal {same}, fields {dbg_keys}")
    out["adv_debug_fields"] = dbg_keys
    st0 = init_sim_state(S, A)
    fields = [f.name for f in dataclasses.fields(st0) if f.name != "tracker"]
    if not all(getattr(st0, f).is_cuda for f in fields):
        raise AssertionError("init_sim_state: not every field on CUDA")
    out["seconds"] = time.perf_counter() - t0
    return out, launches


E2E_VARIANTS = ("vad", "uniad", "sparsedrive")
E2E_BC_S = 8  # scenarios of phase 18's behaviour-cloning rollouts


def device_profile(torch, fn, calls=3):
    """(CUDA kernels launched, their device ms) per call of `fn`, by
    torch.profiler; "not measured" for both when it traces none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: (getattr(e, "device_time_total", None)  # noqa: E731
                        or getattr(e, "cuda_time_total", 0))
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return "not measured", "not measured"
    return len(kernels) / calls, sum(dev_us(e) for e in kernels) / 1e3 / calls


def e2e_path(torch, tmap, counters, pdm_eval_rate):
    """Phase 18: the E2E camera egos (vad, uniad, sparsedrive; seeded
    weights at the default width) at the bench configuration with the JAX
    CLI's eval defaults (rift_pluto on legacy tokens, 2 CBVs, 2 walkers and
    2 statics): (a) each variant's eval for 40 ticks on the fused loop
    (`run.run_episode_fused`), exact hand-kernel launches (the CBVs' legacy
    acts; the E2E ego launches none), env-steps/s beside phase 12's PDM-Lite
    eval; `vad` on the per-tick loop (`run.run_episode`) too, every SimState
    and criteria field bit-equal to the fused loop's; (b) each variant's
    forward on one tick's cameras on the card against the same model's on
    the CPU (`pred_wp`, `det_boxes`, `det_scores` within 1e-4), the ego's
    waypoints per tick (cameras and model) timed and profiled: kernels
    launched and device ms; (c) VAD's behaviour-cloning fit at S=8 from 40
    ticks of the PDM expert (160 samples, the dataset on the card), 2
    epochs of 10 steps: ms per step, the second epoch's mean loss below
    the first's; (d) `run.main --mode train_ego --ego_cfg sparsedrive` at
    S=8 (its `sparsedrive_bc.npz`), then `--mode eval --ego_cfg
    sparsedrive --ego_weights` it at S=64 for 40 ticks: exact launches,
    the ego's weights the file's."""
    import copy
    import io
    import os
    import shutil

    import numpy as np

    from rift_tpu_torch import policies, run
    from rift_tpu_torch.models.e2e import E2EModel, e2e_inputs
    from rift_tpu_torch.models.e2e import init_e2e_weights
    from rift_tpu_torch.models.e2e.train import bc_dataset, bc_fit, bc_rollout
    from rift_tpu_torch.rollout import ego_waypoints
    from rift_tpu_torch.scenario import TrafficEnv
    from rift_tpu_torch.utils.config import load_config
    from rift_tpu_torch.utils.params_io import flatten_params, jax_flat_params, load_params_npz

    t0 = time.perf_counter()
    out, launches = {"pdm_lite_eval_env_steps_per_s_phase12": pdm_eval_rate}, {}
    env = TrafficEnv(tmap, num_scenarios=S, num_agents=A, max_cbvs=2, num_walkers=2,
                     num_statics=2)
    cbv = policies.RIFTPlutoPolicy(tmap, {**load_config("rift_pluto"), "max_cbvs": 2})
    state0, crit0, spec = env.reset()

    def loop(fn, ego, ticks=CHUNK):
        env.tick = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fn(env, ego, cbv, state0, crit0, spec, ticks)
        torch.cuda.synchronize()
        return res, ticks * S / (time.perf_counter() - t1)

    imgs, target, speed = e2e_inputs(spec, state0, tmap)
    for v in E2E_VARIANTS:
        ego = policies.EGO_POLICY_LIST[v](tmap)
        loop(run.run_episode_fused, ego, ticks=20)  # warm-up
        zero_launches(counters)
        (st, cr), rate = loop(run.run_episode_fused, ego)
        launches[f"e2e_{v}_eval"] = read_launches(counters)
        check_counts(f"{v} eval", launches[f"e2e_{v}_eval"], act_launches(CHUNK, legacy=True))
        res = {"env_steps_per_s": rate, "driving_ticks": CHUNK,
               "ego_moved_m_median": torch.linalg.norm(
                   st.pos[:, 0] - state0.pos[:, 0], dim=-1).median().item()}
        if not math.isfinite(res["ego_moved_m_median"]):
            raise AssertionError(f"{v} eval: non-finite ego positions")
        if v == "vad":
            zero_launches(counters)
            (pst, pcr), res["per_tick_env_steps_per_s"] = loop(run.run_episode, ego)
            launches["e2e_vad_eval_per_tick"] = read_launches(counters)
            check_counts("vad per-tick eval", launches["e2e_vad_eval_per_tick"],
                         act_launches(CHUNK, legacy=True))
            apart = fields_apart(torch, st, pst) + fields_apart(torch, cr, pcr, "crit.")
            if apart:
                raise AssertionError(f"vad: per-tick vs fused loop fields {apart} differ")
            res["per_tick_vs_fused_fields_apart"] = apart

        # (b) the forward on the card against the CPU, one tick's inputs
        with torch.no_grad():
            got = ego.model(imgs, target, speed)
            ref = copy.deepcopy(ego.model).cpu()(imgs.cpu(), target.cpu(), speed.cpu())
        err = {k: (got[k].cpu() - ref[k]).abs().max().item()
               for k in ("pred_wp", "det_boxes", "det_scores")}
        if not max(err.values()) <= 1e-4:
            raise AssertionError(f"{v}: card forward vs CPU {err}")
        res["card_vs_cpu_max_abs_err"] = err
        wp = lambda ego=ego: ego_waypoints("e2e", tmap, spec, state0, ego.model)  # noqa: E731
        zero_launches(counters)
        res["ego_ms_per_tick"] = time_calls(torch, wp, 5, warmup=2)
        res["ego_kernels_per_tick"], res["ego_device_ms_per_tick"] = device_profile(torch, wp)
        if any(read_launches(counters).values()):
            raise AssertionError(f"{v}: the E2E ego launched a hand kernel")
        out[v] = res
    del env, cbv

    # (c) VAD's behaviour-cloning fit at S=8, the dataset on the card
    env8 = TrafficEnv(tmap, num_scenarios=E2E_BC_S, num_agents=A)
    st8, cr8, spec8 = env8.reset()
    t1 = time.perf_counter()
    data = bc_dataset(tmap, spec8, bc_rollout(tmap, spec8, st8, cr8, CHUNK))
    torch.cuda.synchronize()
    n = data["imgs"].shape[0]
    model = init_e2e_weights(E2EModel("vad"), torch.Generator().manual_seed(0)).to(tmap.device)
    zero_launches(counters)
    t2 = time.perf_counter()
    losses = bc_fit(model, data, epochs=2, batch_size=16)
    torch.cuda.synchronize()
    steps = len(losses)
    first, second = np.mean(losses[:steps // 2]), np.mean(losses[steps // 2:])
    if not (steps == 2 * (n // 16) and all(map(math.isfinite, losses)) and second < first):
        raise AssertionError(f"vad BC fit: {steps} steps, losses {losses}")
    if any(read_launches(counters).values()):
        raise AssertionError("vad BC fit launched a hand kernel")
    out["bc_fit"] = {
        "variant": "vad", "scenarios": E2E_BC_S, "ticks": CHUNK, "samples": n,
        "dataset_bytes": sum(t.numel() * t.element_size() for t in data.values()),
        "rollout_and_dataset_s": t2 - t1, "ms_per_step": (time.perf_counter() - t2) * 1e3 / steps,
        "losses": losses, "epoch_mean_losses": [float(first), float(second)],
    }
    del data, model

    # (d) the CLI: train_ego, then eval with the fitted weights
    cli_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_cli_e2e")
    shutil.rmtree(cli_dir, ignore_errors=True)
    common = ["--num_agents", str(A), "--blocks", "2", "--num_episodes", "1",
              "--max_ticks", str(CHUNK), "--out_dir", cli_dir, "--ego_cfg", "sparsedrive"]
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as o:
        run.main(["--mode", "train_ego", "--num_scenario", str(E2E_BC_S), *common])
    npz = os.path.join(cli_dir, "train_ego", "sparsedrive-rift_pluto-seed0", "model_ckpt",
                       "sparsedrive_bc.npz")
    lines = [ln for ln in o.getvalue().splitlines() if "BC loss" in ln]
    if not (os.path.exists(npz) and lines):
        raise AssertionError(f"CLI train_ego sparsedrive: no {npz} or no BC loss printed")
    out["cli_train_ego_s"] = time.perf_counter() - t1
    out["cli_train_ego"] = lines[0]
    zero_launches(counters)
    t1 = time.perf_counter()
    with recording(run.EGO_POLICY_LIST, "sparsedrive", lambda p: None) as made, \
            contextlib.redirect_stdout(io.StringIO()):
        g = run.main(["--mode", "eval", "--num_scenario", str(S), "--ego_weights", npz, *common])
    torch.cuda.synchronize()
    out["cli_eval_s"] = time.perf_counter() - t1
    launches["cli_e2e_eval"] = read_launches(counters)
    check_counts("CLI sparsedrive eval", launches["cli_e2e_eval"],
                 act_launches(CHUNK, legacy=True))
    saved = flatten_params(load_params_npz(npz))
    held = jax_flat_params(made[0][0].model)
    if sorted(saved) != sorted(held) or any(not np.array_equal(saved[k], held[k])
                                            for k in saved):
        raise AssertionError("CLI eval: the sparsedrive ego's weights are not the npz's")
    if g.total_routes != S or not math.isfinite(g.avg_driving_score):
        raise AssertionError(f"CLI sparsedrive eval: {g.total_routes} routes, driving score "
                             f"{g.avg_driving_score}")
    out["cli_eval_avg_driving_score"] = g.avg_driving_score
    out["seconds"] = time.perf_counter() - t0
    return out, launches


SHARD_S, SHARD_RANKS = 8, 2  # phase 19: scenarios, and ranks over gloo on the one card
SHARD_TICKS, SHARD_BUFFER, SHARD_BATCH = 2 * CHUNK, 128, 32
RANK_TIMEOUT_S = 300


def shard_config():
    """Phase 19's Runner: the bench width (A=24, C=3, depth 4, bf16,
    canonical tokens) at S=8, one 80-tick train episode whose buffer of 128
    fills for one fit round of 2 epochs of 4 steps."""
    from rift_tpu_torch.rl import TrainConfig
    from rift_tpu_torch.runner import RunnerConfig

    return RunnerConfig(num_scenarios=SHARD_S, num_agents=A, max_cbvs=C,
                        max_episode_ticks=SHARD_TICKS, buffer_capacity=SHARD_BUFFER,
                        canonical=True,
                        train=TrainConfig(epochs=2, warmup_epochs=1, batch_size=SHARD_BATCH))


def shard_train_episode(torch, runner, counters):
    """`Runner.train_cbv` for one episode (its fit round included), its
    kernel launches and seconds; returns (final state of this process's
    scenarios, losses, launches, ticks, seconds)."""
    episode = {}
    run_episode = runner.run_episode

    def kept(*a, **k):
        episode["out"] = run_episode(*a, **k)
        return episode["out"]

    runner.run_episode = kept
    torch.cuda.synchronize()
    zero_launches(counters)
    t1 = time.perf_counter()
    losses = runner.train_cbv(num_episodes=1, chunk=CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = read_launches(counters)
    if runner.train_rounds != 1:
        raise AssertionError(f"sharded train_cbv: buffer {runner.buffer.size} of "
                             f"{SHARD_BUFFER}; no fit round")
    ticks = runner.env.tick
    steps = runner.cfg.train.epochs * (SHARD_BUFFER // SHARD_BATCH)
    check_counts(f"train_cbv at S={runner.env.num_scenarios}", launches,
                 add(act_launches(ticks, train=True, map_tokens=True), fit_launches(steps)))
    return episode["out"][0], losses, launches, ticks, seconds


def shard_rank(rank, port, out_dir):
    """One of phase 19's two ranks (`python3 chip_smoke.py --shard-rank R
    PORT DIR`): joins the gloo group on the card, runs the sharded
    `Runner.train_cbv`, and writes its launches, losses, a digest of its
    parameters and the gathered final state to DIR."""
    import hashlib
    import os

    import torch

    from rift_tpu_torch.map import make_grid_town
    from rift_tpu_torch.parallel import init_distributed, replicate_global
    from rift_tpu_torch.parallel.mesh import gather_scenarios
    from rift_tpu_torch.runner import Runner

    if not torch.cuda.is_available():
        return 1
    t0 = time.perf_counter()
    init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=SHARD_RANKS,
                     process_id=rank, local_device_ids=[0], backend="gloo")
    counters = kernel_counters()
    runner = Runner(make_grid_town(blocks=2, num_lanes=2), shard_config())
    if runner.mesh is None or runner.mesh.size() != SHARD_RANKS:
        raise AssertionError("the Runner did not shard")
    state, losses, launches, ticks, seconds = shard_train_episode(torch, runner, counters)
    replicate_global(dict(runner.model.state_dict()), runner.mesh)  # raises if apart
    digest = hashlib.sha256()
    for name, p in runner.model.state_dict().items():
        digest.update(name.encode() + p.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    gathered = gather_scenarios((state.pos, state.is_cbv, state.alive), runner.mesh)
    torch.save([t.cpu() for t in gathered], os.path.join(out_dir, f"state_{rank}.pt"))
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
        json.dump({"launches": launches, "losses": losses, "params_sha256": digest.hexdigest(),
                   "ticks": ticks, "train_cbv_s": seconds, "local_scenarios":
                   int(state.pos.shape[0]), "records": len(runner.stats.records),
                   "seconds": time.perf_counter() - t0}, f)
    torch.distributed.destroy_process_group()
    return 0


def world_frame_numpy(np, cbv_out, prev_state):
    """rift_tpu/run.py:797-811, on the host: scenario 0's executed CBV
    trajectories from their local frames into the world frame."""
    mask = cbv_out["mask"][0].cpu().numpy()
    tr = cbv_out["traj"][0].cpu().numpy()[mask]
    hd = prev_state.heading[0].cpu().numpy()[mask]
    ps = prev_state.pos[0].cpu().numpy()[mask]
    c, s = np.cos(hd)[:, None], np.sin(hd)[:, None]
    return np.stack([tr[..., 0] * c - tr[..., 1] * s + ps[:, None, 0],
                     tr[..., 0] * s + tr[..., 1] * c + ps[:, None, 1]], axis=-1)


def shard_and_render(torch, tmap, counters, scene):
    """Phase 19: (a) the Runner's shard path on the card's one H100: two
    ranks over gloo, both on cuda:0 (NCCL refuses two ranks on one device),
    run `Runner.train_cbv` for one 80-tick episode at S=8 (4 a rank) and its
    fit round; this process runs the same unsharded meanwhile. The gathered
    final states match the single process's at phase 9's f32 closed-loop
    bound (shares of agents and of CBVs more than 1 cm apart or with
    another CBV flag; at S=8 one agent may be); the fit's parameters are the same bits on both ranks; each
    rank's hand-kernel launches are exact, counted as phases 9 and 16 count
    them. A one-rank NCCL group then joins through `init_distributed` and
    runs the collectives the shard path uses. (b) `--render`: with
    matplotlib, `run.main --render` for 10 ticks at S=4 and its files;
    without it, the ImportError that names it. Either way the observer's
    world-frame candidates (`run.world_frame_candidates`, on the card, and
    through `run.render_observer`) against their host recomputation on a
    scene with CBVs."""
    import os
    import shutil
    import socket
    import tempfile

    import numpy as np

    from rift_tpu_torch import run
    from rift_tpu_torch.models.pluto import canonical_map_tokens, pluto_cbv_act
    from rift_tpu_torch.parallel import init_distributed, make_mesh, replicate, shard_batch
    from rift_tpu_torch.parallel.mesh import gather_scenarios
    from rift_tpu_torch.runner import Runner

    t0 = time.perf_counter()
    out, launches = {}, {}
    work = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r), str(port), work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(SHARD_RANKS)]
    try:
        # the same episode unsharded, in this process, while the ranks run
        one = Runner(tmap, shard_config())
        state1, losses1, launches["shard_single_process"], ticks1, seconds1 = \
            shard_train_episode(torch, one, counters)
        logs = []
        for p in procs:
            log, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            logs.append(log)
            if p.returncode != 0:
                raise AssertionError(f"phase 19 rank failed:\n{log[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(work, f"rank_{r}.json")) as f:
            ranks.append(json.load(f))
        launches[f"shard_rank_{r}"] = ranks[-1]["launches"]
    pos, is_cbv, alive = torch.load(os.path.join(work, "state_0.pt"))
    shutil.rmtree(work, ignore_errors=True)
    if len({r["params_sha256"] for r in ranks}) != 1 or ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"phase 19: the ranks' fits differ: {ranks}")
    if any(r["ticks"] != ticks1 or r["records"] != SHARD_S or
           r["local_scenarios"] != SHARD_S // SHARD_RANKS for r in ranks):
        raise AssertionError(f"phase 19: ticks, records or shards {ranks}, one process "
                             f"{ticks1} ticks")
    if not all(math.isfinite(x) for x in ranks[0]["losses"][0] + losses1[0]):
        raise AssertionError(f"phase 19 losses {ranks[0]['losses']} {losses1}")
    # the ranks' bf16 products run on 4 scenarios where the one process's
    # run on 8, and cuBLAS may round them otherwise: the closed loop is held
    # to phase 9's shares of agents apart, which at S=8 (192 agents, a few
    # CBVs) would admit no agent at all, so one may end apart
    pos, is_cbv = pos.cuda(), is_cbv.cuda()
    apart = (torch.linalg.norm(pos - state1.pos, dim=-1) > 1e-2) | (is_cbv != state1.is_cbv)
    cbv = is_cbv | state1.is_cbv
    shares = {"agents": apart.numel(), "agents_apart": int(apart.sum()),
              "cbvs_at_end": int(cbv.sum()), "cbvs_apart": int(apart[cbv].sum()),
              "max_pos_err_of_the_rest": (pos - state1.pos)[~apart].abs().max().item()}
    if not (shares["agents_apart"] <= max(1, int(LOOP_AGENTS_APART * apart.numel()))
            and shares["cbvs_apart"] <= max(1, int(LOOP_CBVS_APART * int(cbv.sum())))):
        raise AssertionError(f"phase 19: sharded vs one process {shares} (bounds: shares "
                             f"{LOOP_AGENTS_APART} and {LOOP_CBVS_APART}, or one agent)")
    out["shard"] = {
        "scenarios": SHARD_S, "ranks": SHARD_RANKS, "backend": "gloo", "ticks": ticks1,
        "fit_steps": one.cfg.train.epochs * (SHARD_BUFFER // SHARD_BATCH),
        "rank_losses": ranks[0]["losses"], "single_process_losses": losses1,
        "params_same_bits": True, "rank_train_cbv_s": [r["train_cbv_s"] for r in ranks],
        "rank_seconds": [r["seconds"] for r in ranks], "single_process_train_cbv_s": seconds1,
        **shares,
    }

    # a one-rank NCCL group: the collectives of the shard path on the card
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if not init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                            process_id=0):
        raise AssertionError("init_distributed did not join")
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError(f"backend {torch.distributed.get_backend()}, not nccl")
        mesh = make_mesh()
        tree = {"x": torch.arange(12.0, device="cuda").reshape(4, 3),
                "m": torch.ones(4, dtype=torch.bool, device="cuda")}
        back = gather_scenarios(shard_batch(replicate(tree, mesh), mesh), mesh)
        t = torch.ones(3, device="cuda")
        torch.distributed.all_reduce(t)
        if not (torch.equal(back["x"], tree["x"]) and torch.equal(t, torch.ones(3, device="cuda"))
                and mesh.mesh_dim_names == ("scenario",)):
            raise AssertionError("one-rank NCCL collectives")
    finally:
        torch.distributed.destroy_process_group()
    out["nccl_one_rank"] = "ok"

    # (b) --render
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    render_dir = os.path.join(here, "build", "chip_smoke_render")
    shutil.rmtree(render_dir, ignore_errors=True)
    argv = ["--mode", "eval", "--render", "--num_scenario", "4", "--max_ticks", "10",
            "--num_episodes", "1", "--out_dir", render_dir]
    if have_mpl:
        run.main(argv)
        files = sorted(os.listdir(os.path.join(render_dir, "eval", "pdm_lite-rift_pluto-seed0",
                                               "video_ep0")))
        if "ep0_last.png" not in files or not any(f.startswith("ep0.") for f in files):
            raise AssertionError(f"--render wrote {files}")
        out["render"] = {"ran": "run.main --render", "files": files}
    else:
        try:
            run.main(argv)
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise
            out["render"] = {"ran": "ImportError", "error": str(e)}
        else:
            raise AssertionError("--render without matplotlib did not raise")
    # the observer's world-frame candidates on the card against the host
    state, spec = scene
    tok = canonical_map_tokens(one.model, tmap)
    cbv_out = pluto_cbv_act(one.model, tmap, spec, state, max_cbvs=C, canonical=True,
                            map_tok=tok)
    got = run.world_frame_candidates(cbv_out, state)
    want = world_frame_numpy(np, cbv_out, state)
    captured = []

    class Frames:  # a recorder that keeps what the observer hands it
        def keeps(self, tick):
            return True

        def maybe_capture(self, st, scenario=0, tick=None, **kw):
            captured.append(kw["candidates"])

    class Env:
        tick = 5

    run.render_observer(Env, spec, Frames())(state, state, None, None, cbv_out)
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or len(want) == 0 or not err <= 1e-4 or \
            not np.array_equal(captured[0], got):
        raise AssertionError(f"world-frame candidates {got.shape} vs {want.shape}: {err}")
    out["render"].update(world_frame_candidates=int(len(want)), world_frame_max_abs_err=err)
    print(f"# phase 19 --render: {out['render']['ran']}", file=sys.stderr)
    out["seconds"] = time.perf_counter() - t0
    return out, launches


# phase 20: the quality protocol at its smoke scale (2 scenarios, 40 train
# and eval ticks, one episode a stage) with the bench's 24 agents, whose
# rule recognition finds CBVs by tick 40 (at --smoke's 8 it finds none, and
# nothing fits); its train_cbv runs get a buffer of TOOLS_BUFFER samples,
# which the second chunk of 20 ticks fills: each fits one round of 16 steps
TOOLS_ARGS = ["--num_scenario", "2", "--num_agents", str(A), "--train_scenarios", "2",
              "--pretrain_episodes", "1", "--finetune_episodes", "1", "--train_ticks", "40",
              "--eval_ticks", "40", "--eval_episodes", "1", "--methods", "rift_pluto",
              "--seeds", "0"]
TOOLS_BUFFER = 16
HISTORY_ENCODER_KEY = "/HistoryEncoder_0/"  # its tensors in a pretrain npz
TOOLS_ROWS = ("standard", "pluto", "rift_pluto")  # the eval matrix at seed 0
TOPOLOGY_TICKS = 150


def tool_process(args, log_path, cwd):
    """`python -m <args>` started in the background, its output to
    `log_path`, with two intra-op threads: it and this process share the
    host's cores, and torch's default pools, one thread a core each, spin
    against each other."""
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def wait_tool(proc, log_path, timeout):
    """Wait for a tool_process; its exit code must be 0. Returns the
    seconds of each of its `run.py` processes, from the log."""
    import re

    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        log = f.read()
    if rc != 0:
        raise AssertionError(f"{log_path}: exit {rc}\n{log[-4000:]}")
    return [int(x) for x in re.findall(r"^=== done in (\d+)s$", log, re.M)]


def quality_outputs(np, check_eval, out_dir, tuned_differs=True):
    """Phase 20's checks of one quality-protocol run: the stage-1 pretrain
    written, the tuned rift_pluto npz (different from it, if asked), the
    eval matrix's 3 rows at seed 0 with records, "±" entries in
    merged.json, and the port's check_eval passing on the eval dir.
    Returns what it read."""
    import os

    art = os.path.join(out_dir, "artifacts")
    pre, tuned = (np.load(os.path.join(art, f)) for f in ("pluto_pretrain.npz",
                                                         "rift_pluto.npz"))
    moved = sorted(k for k in pre.files if not np.array_equal(pre[k], tuned[k]))
    if sorted(pre.files) != sorted(tuned.files) or (tuned_differs and not moved):
        raise AssertionError(f"{out_dir}: the tuned npz moves {len(moved)} tensors")
    base = os.path.join(out_dir, "eval", "eval")
    rows = {}
    for cbv in TOOLS_ROWS:
        with open(os.path.join(base, f"pdm_lite-{cbv}-seed0", "simulation_results.json")) as f:
            rows[cbv] = len(json.load(f)["records"])
    if sorted(os.listdir(base)) != sorted(f"pdm_lite-{c}-seed0" for c in TOOLS_ROWS) or \
            not all(rows.values()):
        raise AssertionError(f"{out_dir}: eval rows {sorted(os.listdir(base))}, records {rows}")
    with open(os.path.join(out_dir, "merged.json")) as f:
        merged = json.load(f)
    if sorted(merged) != sorted(f"pdm_lite-{c}" for c in TOOLS_ROWS) or \
            not all("±" in row["Driving Score"] for row in merged.values()):
        raise AssertionError(f"{out_dir}: merged table {merged}")
    if check_eval.main(["--base_dir", base, "--expected_routes", "2"]) != len(TOOLS_ROWS):
        raise AssertionError(f"{out_dir}: check_eval")
    return {"tensors_tuned": len(moved), "tensors": len(pre.files), "records": rows,
            "driving_score": {k: v["Driving Score"] for k, v in merged.items()}}


def results_table(path):
    """The first table of a quality RESULTS.md: its header and one row of
    one seed per CBV of the eval matrix, RIFT last."""
    with open(path) as f:
        lines = f.read().splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("| CBV method | seeds"))
    rows = lines[start + 2:start + 2 + len(TOOLS_ROWS) + 1]
    names = [row.split(" | ")[0][2:] for row in rows[:-1]]
    if names != ["standard", "pluto", "**RIFT (ours)**"] or rows[-1] or \
            not all(row.split(" | ")[1] == "1" for row in rows[:-1]):
        raise AssertionError(f"{path}: table rows {rows}")
    return rows[:-1]


def tools_path(torch, counters, route_file):
    """Phase 20: the experiment protocols and result tools
    (rift_tpu_torch/tools). (a) The quality protocol as a user runs it,
    `quality_experiment --smoke`, a fresh process a stage, in the background
    while this process runs it at TOOLS_ARGS with `run_cli` calling
    `run.main` here, each train_cbv stage with a buffer of TOOLS_BUFFER so
    that it fits, the counters read around each stage: exact launches per
    stage (train acts and fit steps, the bc_pluto fit through the stage
    kernel); the bc_pluto fit moving every HistoryEncoder tensor from the
    policy's weights as built; each run's pretrain, tuned npz, eval rows,
    merged table and check_eval (quality_outputs), and the RESULTS.md.
    (b) `topology_eval --ticks 150` with this run's pretrain: both rows,
    the pluto row's launches exact. (c) `ego_zoo_experiment --smoke`: whole
    with h5py, else the ImportError that names it at stage 1."""
    import importlib.util
    import os
    import shutil

    import numpy as np

    from rift_tpu_torch import policies, run
    from rift_tpu_torch.tools import check_eval, ego_zoo_experiment, quality_experiment
    from rift_tpu_torch.tools import topology_eval
    from rift_tpu_torch.utils.params_io import jax_flat_params

    t0 = time.perf_counter()
    out, launches = {}, {}
    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, "build", "chip_smoke_tools")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    tool = "rift_tpu_torch.tools.quality_experiment"
    smoke_log = os.path.join(base, "smoke.log")
    proc = tool_process([tool, "--smoke", "--routes", route_file, "--out",
                         os.path.join(base, "smoke")], smoke_log, here)
    try:
        # the stages at TOOLS_ARGS here, through run.main, a stage's counters
        # apiece; the bc_pluto policy's weights as built
        chunks, stages, built = [], [], {}
        rollout_chunk = run.rollout_chunk

        def counted_chunk(*a, **kw):
            if kw["with_policy"]:
                chunks.append((kw["num_steps"], kw["train"]))
            return rollout_chunk(*a, **kw)

        def run_here(argv, cpu=False):  # quality_experiment.run_cli's signature
            key = argv[argv.index("--cbv_cfg") + 1]
            mode = argv[argv.index("--mode") + 1]
            if mode == "train_cbv":
                argv = [*argv, f"buffer_capacity={TOOLS_BUFFER}"]
            chunks.clear()
            zero_launches(counters)
            # copies: on the CPU the flat arrays would share the parameters' memory
            snapshot = (lambda p: {k: v.copy() for k, v in jax_flat_params(p.model).items()}) \
                if key == "bc_pluto" else (lambda p: None)
            with recording(policies.CBV_POLICY_LIST, key, snapshot) as made:
                run.main(argv)
            torch.cuda.synchronize()
            got = read_launches(counters)
            pol, built[key] = made[0]
            want = add(*[act_launches(n, train=train, legacy=True) for n, train in chunks]) \
                if chunks else {k: 0 for k in got}
            rounds = getattr(pol, "train_rounds", 0)
            if rounds:
                cfg = pol.train_cfg
                steps = cfg.epochs * max(pol.buffer_capacity // cfg.batch_size, 1)
                want = add(want, fit_launches(rounds * steps, encoder_trains=key == "bc_pluto"))
            stages.append({"mode": mode, "cbv": key, "ticks": sum(n for n, _ in chunks),
                           "fit_rounds": rounds, "launches": got})
            launches[f"quality_{mode}_{key}"] = got
            check_counts(f"quality {mode} {key}", got, want)

        run_cli = quality_experiment.run_cli
        run.rollout_chunk = counted_chunk
        quality_experiment.run_cli = run_here
        try:
            t1 = time.perf_counter()
            here_dir = os.path.join(base, "here")
            quality_experiment.main(["--routes", route_file, "--out", here_dir,
                                     "--results_dir", os.path.join(base, "here_results"),
                                     *TOOLS_ARGS])
            out["quality_here_s"] = time.perf_counter() - t1
        finally:
            run.rollout_chunk = rollout_chunk
            quality_experiment.run_cli = run_cli
        want_stages = [("train_cbv", "bc_pluto", 40, 1), ("train_cbv", "rift_pluto", 40, 1),
                       ("eval", "standard", 0, 0), ("eval", "pluto", 40, 0),
                       ("eval", "rift_pluto", 40, 0)]
        got_stages = [(st["mode"], st["cbv"], st["ticks"], st["fit_rounds"]) for st in stages]
        if got_stages != want_stages:
            raise AssertionError(f"quality stages {got_stages}, expected {want_stages}")
        out["quality_stages"] = stages
        out["quality_here"] = quality_outputs(np, check_eval, here_dir)
        out["results_table"] = results_table(os.path.join(base, "here_results", "RESULTS.md"))
        # the pretrain against the bc_pluto policy's weights as built: its fit
        # (the stage kernel's backward) moves every HistoryEncoder tensor
        init = built["bc_pluto"]
        pre = np.load(os.path.join(here_dir, "artifacts", "pluto_pretrain.npz"))
        moved = {k for k in init if not np.array_equal(init[k], pre[k])}
        encoder = [k for k in init if HISTORY_ENCODER_KEY in k]
        if sorted(pre.files) != sorted(init) or not encoder or \
                not moved.issuperset(encoder):
            raise AssertionError(f"bc_pluto pretrain: {len(moved)} of {len(init)} tensors "
                                 f"moved, HistoryEncoder unmoved "
                                 f"{sorted(set(encoder) - moved)}")
        out["pretrain_moved"] = {"tensors_moved": len(moved), "tensors": len(init),
                                 "history_encoder_tensors": len(encoder)}

        # (b) the topology eval with the pretrain just made
        topo = {}
        run_one, chunk_fn = topology_eval.run_one, topology_eval.rollout_chunk

        def counted_run_one(tmap, routes, paths, cbv_name, args):
            chunks.clear()
            zero_launches(counters)
            res = run_one(tmap, routes, paths, cbv_name, args)
            torch.cuda.synchronize()
            topo[cbv_name] = (read_launches(counters), sum(n for n, _ in chunks))
            return res

        def topo_chunk(*a, **kw):
            chunks.append((kw["num_steps"], kw["train"]))
            return chunk_fn(*a, **kw)

        topology_eval.run_one, topology_eval.rollout_chunk = counted_run_one, topo_chunk
        try:
            t1 = time.perf_counter()
            topology_eval.main(["--ticks", str(TOPOLOGY_TICKS), "--pretrain",
                                os.path.join(here_dir, "artifacts", "pluto_pretrain.npz"),
                                "--out", os.path.join(base, "topology")])
            out["topology_s"] = time.perf_counter() - t1
        finally:
            topology_eval.run_one, topology_eval.rollout_chunk = run_one, chunk_fn
        with open(os.path.join(base, "topology", "topology.json")) as f:
            rows = json.load(f)["rows"]
        if sorted(rows) != ["pluto", "standard"] or sorted(topo) != ["pluto", "standard"]:
            raise AssertionError(f"topology rows {sorted(rows)}, runs {sorted(topo)}")
        for name, (got, ticks) in topo.items():
            launches[f"topology_{name}"] = got
            check_counts(f"topology {name}", got,
                         act_launches(ticks if name == "pluto" else 0, legacy=True))
        out["topology"] = {name: {"ticks": topo[name][1], "verify": r["verify"],
                                  "avg_driving_score": r["stats"].get("avg_driving_score")}
                           for name, r in rows.items()}

        # (c) the ego zoo at its smoke scale
        t1 = time.perf_counter()
        zoo_argv = ["--smoke", "--routes", route_file, "--out", os.path.join(base, "ego_zoo"),
                    "--quality_artifacts", os.path.join(here_dir, "artifacts"),
                    "--results_dir", os.path.join(base, "ego_zoo_results")]
        try:
            ego_zoo_experiment.main(zoo_argv)
            out["ego_zoo"] = "ran whole"
        except ImportError as e:
            if "h5py" not in str(e) or importlib.util.find_spec("h5py") is not None:
                raise
            out["ego_zoo"] = f"ImportError at stage 1: {e}"
        out["ego_zoo_s"] = time.perf_counter() - t1

        # (a) the run of fresh processes a stage
        out["quality_smoke_run_s"] = wait_tool(proc, smoke_log, timeout=600)
        out["quality_smoke"] = quality_outputs(np, check_eval, os.path.join(base, "smoke"),
                                               tuned_differs=False)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t0
    return out, launches


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
    from rift_tpu_torch.ops import attention, build, history, points, refline, retrack
    from rift_tpu_torch.rl import TrainConfig, fit, rift_loss_fn, ring_append, ring_init
    from rift_tpu_torch.rl import evaluator

    counters = kernel_counters()
    t0 = time.perf_counter()
    # ---- phase 1: build
    logs = build.build_all(
        ["attention", "points", "retrack", "refline", "history_stage", "history_encoder"]
    )
    usage = {name: ptxas_usage(log) for name, log in logs.items()}
    for name, fns in usage.items():
        for fn, (regs, st, ld) in fns.items():
            print(f"# {name}: {fn}: {regs} registers, spill stores {st} B, loads {ld} B",
                  file=sys.stderr)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"# build {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 2: kernels against their plain versions (the map's lane
    # count sizes the map-token check), and the gradients through them
    tmap = make_grid_town(blocks=2, num_lanes=2)
    results = {
        "fused_attention": {**check_attention(torch, attention),
                            "ptxas": usage["attention"],
                            "plant": check_plant_attention(torch, attention)},
        "points_encoder": check_points(torch, points, tmap.num_lanes),
        "retrack_rollout": check_retrack(torch, retrack),
        "refline_matrices": check_refline(torch, refline),
        "local_stage": check_history(torch, history),
        "history_encoder": check_history_encoder(torch, history),
    }
    grad_err = check_gradients(torch, attention, points, history)
    for name in ("points_encoder", "local_stage", "history_encoder"):
        r = results[name]
        print(f"# {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, {r['timed_work']}); "
              f"{r['fit_ms']:.4f} ms (bound {r['fit_bound_ms']:.4f}, {r['fit_timed_work']})",
              file=sys.stderr)
    print(f"# map L={tmap.num_lanes}, kernels checked {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # ---- phase 3: scenes
    scenes = [make_scene(torch, tmap, seed) for seed in SEEDS]
    print(f"# scenes {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 4: the eval act step at full width
    torch.manual_seed(0)
    model = PlutoModel(encoder_depth=4, decoder_depth=4).eval()
    launches = {}
    zero_launches(counters)
    map_tok = canonical_map_tokens(model, tmap)
    outs = [
        pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, canonical=True, map_tok=map_tok)
        for state, spec in scenes
    ]
    torch.cuda.synchronize()
    launches["eval_act"] = read_launches(counters)
    check_counts("eval act", launches["eval_act"], act_launches(len(scenes), map_tokens=True))
    for out in outs:
        valid = int((out["cbv_slots"] >= 0).sum())
        if valid != S * C:
            raise AssertionError(f"{valid} valid CBV slots, expected {S * C}")
        if not torch.isfinite(out["traj"]).all() or int(out["mask"].sum()) != S * C:
            raise AssertionError("non-finite waypoints or a wrong CBV mask")
    state, spec = scenes[0]
    act_ms = time_calls(
        torch, lambda: pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, canonical=True,
                                     map_tok=map_tok),
        10, warmup=2,
    )
    print(f"# eval path done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 5: f32 eval act through the kernels vs the plain versions
    model32 = PlutoModel(encoder_depth=4, decoder_depth=4, dtype=torch.float32).eval()
    model32.load_state_dict(model.state_dict())
    tok32 = canonical_map_tokens(model32, tmap)
    kernel_fns = (layers.fused_attention, layers.points_encoder, layers.local_stage,
                  layers.history_encoder, evaluator.refline_matrices, evaluator.retrack_rollout)

    def plain_versions():
        layers.fused_attention = attention.fused_attention_ref
        layers.points_encoder = (
            lambda x, m, w, out_dim, has_ln=True: points.points_forward_ref(x, m, w, has_ln)
        )
        layers.local_stage = history.local_stage_ref
        layers.history_encoder = history.history_encoder_ref
        evaluator.refline_matrices = refline.refline_matrices_ref
        evaluator.retrack_rollout = retrack.retrack_rollout_ref

    def kernel_versions():
        (layers.fused_attention, layers.points_encoder, layers.local_stage,
         layers.history_encoder, evaluator.refline_matrices, evaluator.retrack_rollout) = kernel_fns

    got = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, canonical=True, map_tok=tok32)
    plain_versions()
    try:
        ref = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C,
                            canonical=True, map_tok=canonical_map_tokens(model32, tmap))
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
    zero_launches(counters)
    train_outs = [
        pluto_cbv_act(model, tmap, spec_, state_, max_cbvs=C, train=True, canonical=True,
                      map_tok=map_tok)
        for state_, spec_ in scenes
    ]
    torch.cuda.synchronize()
    launches["train_act"] = read_launches(counters)
    check_counts("train act", launches["train_act"], act_launches(len(scenes), train=True))
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
                                     canonical=True, map_tok=map_tok), 5, warmup=2,
    )
    print(f"# train act done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 7: f32 train act through the kernels vs the plain versions.
    # The re-tracking is chaotic at near-ties (a closest point or a brake
    # threshold met on one side only), and collision and off-road flags are
    # discrete, so a flipped candidate's return moves by up to ~20: the
    # share of candidates off by more than 1e-2 is bounded, not forbidden.
    got = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, train=True, canonical=True,
                        map_tok=tok32)
    plain_versions()
    try:
        ref = pluto_cbv_act(model32, tmap, spec, state, max_cbvs=C, train=True,
                            canonical=True, map_tok=canonical_map_tokens(model32, tmap))
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
        zero_launches(counters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses += fit(model, buf, rift_loss_fn, cfg, gen, round_idx=round_idx)
        torch.cuda.synchronize()
        fit_ms.append((time.perf_counter() - t1) * 1e3 / steps)
        launches["fit"] = read_launches(counters)
        check_counts("fit", launches["fit"], fit_launches(steps))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fit losses {losses}")
    moved, changed = params_moved(torch, model, before)
    if not moved > 0.0 or changed:
        raise AssertionError(f"fit moved pi_head by {moved}; other params changed: {changed}")
    print(f"# fit done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 9: the closed loop
    loop, loop_launches = closed_loop(torch, tmap, counters, plain_versions,
                                      kernel_versions)
    launches.update(loop_launches)
    print(f"# closed loop done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 10: the fine-tuning zoo and the CLI
    zoo, zoo_launches = zoo_and_cli(torch, tmap, counters, scenes[0])
    launches.update(zoo_launches)
    print(f"# zoo and CLI done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 11: the act steps and a fit on legacy tokens
    legacy, legacy_launches = legacy_path(torch, tmap, counters, scenes, model,
                                          plain_versions, kernel_versions)
    launches.update(legacy_launches)
    print(f"# legacy path done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 12: the closed loop with the default egos and scenes
    pdm_loop, pdm_launches = default_loop(torch, tmap, counters, plain_versions,
                                          kernel_versions)
    launches.update(pdm_launches)
    print(f"# PDM loop done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 13: the CLI with its defaults
    cli, cli_launches = default_cli(torch, counters)
    launches.update(cli_launches)
    print(f"# default CLI done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phases 14-15: route files, the PlanT ego and attention recognition
    import os

    route_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                              "chip_smoke_routes.xml")
    os.makedirs(os.path.dirname(route_file), exist_ok=True)
    write_route_file(route_file)
    route, route_path_launches = route_path(torch, counters, route_file, plain_versions,
                                        kernel_versions)
    launches.update(route_path_launches)
    print(f"# route loop done {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    rcli, rcli_launches = route_cli(torch, counters, route_file)
    launches.update(rcli_launches)
    print(f"# route CLI done {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    for name in ("fused_attention", "points_encoder", "history_encoder"):
        if not launches["route_plant_eval_0"][name] > 0:
            raise AssertionError(f"{name}: no launch on the route eval")

    # ---- phase 16: the per-tick loop, classic PPO and train_ego
    per_tick, per_tick_launches = per_tick_path(torch, tmap, counters)
    launches.update(per_tick_launches)
    print(f"# per-tick loop done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 17: collect_data, PlanT's fit, the converter, the public API
    collect, collect_launches = collect_and_plant(
        torch, tmap, counters, scenes, plain_versions, kernel_versions,
        per_tick["per_tick_env_steps_per_s"])
    launches.update(collect_launches)
    results["points_encoder"]["no_ln"] = collect.pop("points_no_ln")
    print(f"# collect, PlanT fit, converter done {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # ---- phase 18: the E2E camera egos, their BC fit and the CLI
    e2e, e2e_launches = e2e_path(torch, tmap, counters, pdm_loop["eval_env_steps_per_s"])
    launches.update(e2e_launches)
    print(f"# E2E egos done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 19: the shard path over two ranks, NCCL, and --render
    shard, shard_launches = shard_and_render(torch, tmap, counters, scenes[0])
    launches.update(shard_launches)
    print(f"# shard path and render done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- phase 20: the experiment protocols and result tools
    tools, tools_launches = tools_path(torch, counters, route_file)
    launches.update(tools_launches)
    print(f"# tools done {time.perf_counter() - t0:.1f}s (phase 20 {tools['seconds']:.1f}s)",
          file=sys.stderr)

    kernels = []
    sources = {
        "fused_attention": ("rift_tpu_torch/csrc/attention.cu", "rift_tpu/ops/attention.py:78"),
        "points_encoder": ("rift_tpu_torch/csrc/points.cu", "rift_tpu/ops/points.py:116"),
        "retrack_rollout": ("rift_tpu_torch/csrc/retrack.cu", "rift_tpu/ops/retrack.py:234"),
        "refline_matrices": ("rift_tpu_torch/csrc/refline.cu", "rift_tpu/ops/refline.py:88"),
        "local_stage": ("rift_tpu_torch/csrc/history_stage.cu", "rift_tpu/ops/history.py:359"),
        "history_encoder": ("rift_tpu_torch/csrc/history_encoder.cu",
                            "rift_tpu/ops/history.py:251"),
    }
    for name, r in results.items():
        src, replaces = sources[name]
        # each kernel's launches on its path: the closed-loop fine-tune run
        # (Runner.train_cbv), or for the stage kernel the one path that
        # trains the HistoryEncoder, the bc_pluto fit
        path = "fit_bc_pluto" if name == "local_stage" else "closed_loop_train"
        if not launches[path][name] > 0:
            raise AssertionError(f"{name}: no launch on its path {path}")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[path][name], "main_path": path,
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            **r,
        })
    print(json.dumps({
        "card": card,
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
        "closed_loop": loop,
        "zoo_and_cli": zoo,
        "legacy_tokens": legacy,
        "closed_loop_defaults": pdm_loop,
        "cli_defaults": cli,
        "route_plant_eval": route,
        "route_cli": rcli,
        "per_tick": per_tick,
        "collect_and_plant": collect,
        "e2e_egos": e2e,
        "shard_and_render": shard,
        "tools": tools,
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
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
