"""Where the time of one planner act step, one fine-tune step, one closed-loop
tick or one step of PlanT's behaviour-cloning fit goes on the card.

    python3 -m rift_tpu_torch.profile_act [--mode eval|train|fit|world|tick|plant_fit]
        [--steps 5]
        [--legacy] [--ego rule|pdm|expert|plant|ppo|vad|uniad|sparsedrive]
        [--recog rule|attention] [--routes]

Builds the chip_smoke scene (grid town, S=64 x A=24 x C=3, CBVs on slots
1..3; with `--routes`, chip_smoke's route town of its route file's first
batch, S=15, each scenario on its route) and the full-width bf16
PlutoModel, then traces `--steps` calls with
torch.profiler: pluto_cbv_act in eval or train mode (on canonical tokens
with precomputed map tokens, or with `--legacy` on per-CBV tokens), or
(`fit`) the train step of a fine-tune round on a batch of 256 of the train
act's samples. `world` and `tick` reset the scenes and run 30 world-only
ticks first (so that rule recognition has promoted CBVs), then trace the
env step alone (the ego's waypoints of `--ego`, the world tick, criteria,
churn, recognition on every second call: the rule's, or with `--recog
attention` ranked by chip_smoke's PlanT recognizer) or an eval tick (the
act, then the env step). The `plant` ego is chip_smoke's PlanT_medium;
the `ppo` ego (seeded weights, deterministic) drives the ego by raw
controls (env_step's `ego_ctrl`), its act inside each traced call; the
E2E camera egos (`vad`, `uniad`, `sparsedrive`, seeded weights at the
default width) render their cameras and run their model inside each call.
`plant_fit` traces `plant_bc_step` of PlanT_medium (f32, chip_smoke's
seeded weights, AdamW) on a batch of the scene's S = 64 token sets with
seeded waypoint labels, as PlanT's fit runs it.
Prints one JSON line: host wall time per call, device kernel time per call,
the device's idle share, the number of kernel launches per call, the
launches per call of each hand-written kernel (its wrapper's counter) and
its device time per call (all its template instances together), and the
kernels that take the most device time. Run from the repository root (it
reuses chip_smoke's scene set-up).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


# each hand-written kernel's __global__ functions in csrc/
HAND_KERNELS = {
    "fused_attention": ("attention_kernel", "attention_kernel_dh64"),
    "points_encoder": ("points_kernel",), "retrack_rollout": ("retrack_kernel",),
    "refline_matrices": ("refline_kernel",), "local_stage": ("stage_kernel",),
    "history_encoder": ("encoder_kernel",),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("eval", "train", "fit", "world", "tick", "plant_fit"),
                    default="eval")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--legacy", action="store_true", help="per-CBV (legacy) tokens")
    ap.add_argument("--ego", default="rule", choices=(
        "rule", "pdm", "expert", "plant", "ppo", "vad", "uniad", "sparsedrive"))
    ap.add_argument("--recog", choices=("rule", "attention"), default="rule")
    ap.add_argument("--routes", action="store_true", help="chip_smoke's route town")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_act: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from rift_tpu_torch import policies
    from rift_tpu_torch.map import make_grid_town
    from rift_tpu_torch.models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
    from rift_tpu_torch.rl import TrainConfig, gather_batch, make_optimizer, rift_loss_fn
    from rift_tpu_torch.rl import ring_append, ring_init, train_step
    from rift_tpu_torch.rollout import ego_waypoints, rollout_chunk
    from rift_tpu_torch.scenario import TrafficEnv, env_step
    from torch.profiler import ProfilerActivity, profile

    ego_model = recog = None
    ego_kind = "e2e" if args.ego in ("vad", "uniad", "sparsedrive") else args.ego
    if args.ego == "plant" or args.recog == "attention":
        ego_model, recog = cs.plant_models(torch)
        recog = recog if args.recog == "attention" else None
    S = cs.S
    if args.routes:
        from rift_tpu_torch.map import route_waypoints
        from rift_tpu_torch.map.from_route import map_from_routes
        from rift_tpu_torch.scenario.routes import EvalDataLoader, parse_routes_file

        os.makedirs("build", exist_ok=True)
        path = cs.write_route_file("build/profile_routes.xml")
        batch = EvalDataLoader(parse_routes_file(path), cs.S).sampler()
        S = len(batch)
        tmap, paths = map_from_routes([c.keypoints for c in batch], num_lanes=2,
                                      pad_lanes_to=256, stop_ratio=0.25)
        tmap = tmap.replace(light_group=torch.full_like(tmap.light_group, -1))
        env = TrafficEnv(tmap, num_scenarios=S, num_agents=cs.A, max_cbvs=cs.C)
        reset = lambda: env.reset(routes=[route_waypoints(tmap, p) for p in paths],
                                  lane_paths=paths)
        state, _, spec = reset()
    else:
        tmap = make_grid_town(blocks=2, num_lanes=2)
        env = TrafficEnv(tmap, num_scenarios=S, num_agents=cs.A, max_cbvs=cs.C)
        reset = env.reset
        state, spec = cs.make_scene(torch, tmap, 0)
    torch.manual_seed(0)
    model = PlutoModel(encoder_depth=4, decoder_depth=4).eval()
    canonical = not args.legacy
    tok = canonical_map_tokens(model, tmap) if canonical else None
    train = args.mode in ("train", "fit")
    act = lambda: pluto_cbv_act(
        model, tmap, spec, state, max_cbvs=cs.C, train=train, canonical=canonical, map_tok=tok
    )
    if args.mode in ("world", "tick"):
        state, crit, spec = reset()
        state, crit, _ = rollout_chunk(None, tmap, spec, state, crit, max_cbvs=cs.C,
                                       num_steps=30, with_policy=False, recog_model=recog,
                                       tick=0)
        ticks = iter(range(30, 10**6))

        ppo_ego = policies.EgoPPO(tmap) if args.ego == "ppo" else None
        if ego_kind == "e2e":
            ego_model = policies.EGO_POLICY_LIST[args.ego](tmap).init()

        def act():
            if ppo_ego is not None:
                cbv = {"ego_ctrl": ppo_ego.act(spec, state)["ctrl"]}
            else:
                cbv = {"ego_traj": ego_waypoints(ego_kind, tmap, spec, state, ego_model)}
            if args.mode == "tick":
                res = pluto_cbv_act(model, tmap, spec, state, max_cbvs=cs.C,
                                    canonical=canonical, map_tok=tok)
                cbv.update(cbv_traj=res["traj"], cbv_traj_mask=res["mask"])
            # the same state each call: ticks alternate recognition on and off
            return env_step(tmap, spec, state, crit, max_cbvs=cs.C, recog_model=recog,
                            tick=next(ticks), **cbv)
    if args.mode == "fit":
        samples, valid = cs.train_samples(torch, act())
        first = lambda t: {k: first(x) for k, x in t.items()} if isinstance(t, dict) else t[0]
        buf = ring_append(ring_init(first(samples), capacity=256), samples, valid)
        cfg = TrainConfig()
        batch = gather_batch(buf, torch.arange(cfg.batch_size, device="cuda") % buf.size)
        opt = make_optimizer(model, cfg)
        for n, p in model.named_parameters():  # frozen, as fit() holds them
            p.requires_grad_("pi_head" in n)
        act = lambda: train_step(model, opt, rift_loss_fn, batch, cfg.lr, cfg)
    if args.mode == "plant_fit":
        from rift_tpu_torch.models.plant import PlanTModel, build_plant_tokens
        from rift_tpu_torch.models.plant import init_plant_weights
        from rift_tpu_torch.models.plant.train import ADAMW, plant_bc_step

        plant = init_plant_weights(PlanTModel(**cs.PLANT_EGO), torch.Generator().manual_seed(0))
        plant.to("cuda")
        popt = torch.optim.AdamW(plant.parameters(), lr=1e-4, **ADAMW)
        tokens = build_plant_tokens(spec, state)
        labels = torch.randn((S, plant.pred_len, 2),
                             generator=torch.Generator().manual_seed(1)).to("cuda")
        act = lambda: plant_bc_step(plant, popt, *tokens, labels)
    for _ in range(3):
        act()
    torch.cuda.synchronize()

    counters = cs.kernel_counters()
    cs.zero_launches(counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            act()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    hand = {k: n / args.steps for k, n in cs.read_launches(counters).items()}

    def dev_us(e):  # the attribute's name changed across torch versions
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    # device kernels; the GPU-side spans of annotations (the optimizer's
    # `Optimizer.step#...`) cover kernels already counted, and gaps
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name[:80], [0.0, 0])
        rec[0] += dev_us(e) / 1e3
        rec[1] += 1
    device_ms = sum(v[0] for v in by_name.values()) / args.steps
    hand_ms = {
        name: sum(dev_us(e) for e in kernels
                  if any(f"{sym}<" in e.name or f"{sym}(" in e.name for sym in symbols))
        / 1e3 / args.steps
        for name, symbols in HAND_KERNELS.items()
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    print(json.dumps({
        "profile_act": {
            "mode": args.mode,
            "tokens": "canonical" if canonical else "legacy",
            "ego": args.ego,
            "recognition": args.recog,
            "town": "routes" if args.routes else "grid",
            "scenarios": S,
            "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "steps": args.steps,
            "wall_ms_per_call": wall_ms,
            "device_kernel_ms_per_call": device_ms if kernels else "not measured",
            "idle_share": 1.0 - device_ms / wall_ms if kernels else "not measured",
            "launches_per_call": len(kernels) / args.steps,
            "hand_kernel_launches_per_call": hand,
            "hand_kernel_ms_per_call": hand_ms if kernels else "not measured",
            "top_kernels_ms_per_call": {
                name: round(ms / args.steps, 4) for name, (ms, _) in top
            },
        }
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
