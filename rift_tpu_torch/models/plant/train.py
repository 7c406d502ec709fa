"""PlanT's behaviour-cloning fit and the trained recognition scorer (port of
rift_tpu/models/plant/train.py).

The dataset is the CollectBuffer HDF5 stream of SimState snapshots
(rl/collect.py, `python -m rift_tpu_torch.run --mode collect_data`) with the
episode's ego route; tokens are rebuilt by the online builder
(policy.build_plant_tokens), so the fitted weights serve the `plant` ego
and the attention recognizer (scenario/recognition.py) as they are. The
fit is the reference's Lightning training step (lit_module.py): an L1 loss
on the waypoints, AdamW as optax's `adamw(lr)`.

    python -m rift_tpu_torch.run --mode collect_data ...
    python -m rift_tpu_torch.models.plant.train \\
        log/collect_data/<tag>/<ego>_<cbv>.hdf5 [--device cpu]

Reading the HDF5 file needs h5py. The npz is the JAX package's flat-key
format (`save_plant_params`), which `--ego_weights`/`--recog_weights` of
either CLI load.
"""

from __future__ import annotations

import numpy as np
import torch

from ...sim.state import ScenarioSpec, SimState, init_sim_state_host
from ...utils.device import resolve_device
from ...utils.params_io import flatten_params, load_jax_params, load_params_npz
from ...utils.params_io import save_params_npz as save_plant_params  # noqa: F401
from .model import PlanTModel, init_plant_weights
from .policy import MAX_VEHICLE_TOKENS, build_plant_tokens

WAYPOINT_STRIDE = 5  # ticks between label waypoints (0.5 s at 10 fps)
# optax.adamw's defaults: weight decay on every parameter, eps outside the root
ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


def _spec_from_h5(data: dict) -> ScenarioSpec | None:
    """The spec fields that the PlanT tokens read, from the file's static
    ego route (None without one); the rest are neutral fills."""
    if "static_ego_route" not in data:
        return None
    route = np.asarray(data["static_ego_route"])
    n = np.asarray(data["static_ego_route_len"])
    S = route.shape[0]
    L = 4
    return ScenarioSpec(
        ego_route=route,
        ego_route_len=n,
        route_road_ids=np.full((S, 4), -1, np.int32),
        route_lane_ids=np.zeros((S, 4), np.int32),
        ego_target_speed=np.full((S,), 8.0, np.float32),
        timeout_ticks=np.full((S,), 10 ** 6, np.int32),
        route_lane_mask=np.zeros((S, L), bool),
        lane_chains=np.full((S, L, 2, 2), -1, np.int32),
        lane_route_dist=np.full((S, L), 1e9, np.float32),
        lane_route_join=np.zeros((S, L), np.float32),
    )


def plant_bc_dataset(data: dict, pred_len: int = 4, stride: int = WAYPOINT_STRIDE,
                     device=None):
    """CollectBuffer arrays -> (tokens [N, O, 7], target [N, 2], light
    [N, 1], wp_labels [N, pred_len, 2]) on `device` (CUDA unless asked).

    Samples are taken every `stride` ticks while `pred_len * stride` ticks
    follow; the labels are the ego's own future positions at `k * stride`
    (data_agent_boxes label semantics), rotated into the ego frame of the
    sample tick."""
    spec = _spec_from_h5(data)
    if spec is None:
        raise ValueError("h5 lacks static_ego_route (re-collect with "
                         "set_static; run.py collect_episode does this)")
    dev = resolve_device(device)
    spec = spec.to(dev)
    pos = np.asarray(data["pos"])  # [T, S, A, 2]
    heading = np.asarray(data["heading"])
    T, S, A = heading.shape
    frames = {k: torch.from_numpy(np.ascontiguousarray(data[k])).to(dev)
              for k in ("pos", "heading", "speed", "shape", "alive", "ego_route_cursor")}
    base = init_sim_state_host(S, A).to(dev)

    tok_list, tp_list, wp_list = [], [], []
    horizon = pred_len * stride
    for t in range(0, T - horizon, stride):
        st = base.replace(**{k: v[t] for k, v in frames.items()})
        tokens, target, _ = build_plant_tokens(spec, st)
        # future ego positions in the tick-t ego frame (numpy, as the JAX
        # package computes them)
        ego_p = pos[t, :, 0]
        c = np.cos(-heading[t, :, 0])
        sn = np.sin(-heading[t, :, 0])
        wps = []
        for k in range(1, pred_len + 1):
            rel = pos[t + k * stride, :, 0] - ego_p
            wps.append(np.stack([rel[:, 0] * c - rel[:, 1] * sn,
                                 rel[:, 0] * sn + rel[:, 1] * c], axis=-1))
        tok_list.append(tokens)
        tp_list.append(target)
        wp_list.append(np.stack(wps, axis=1))  # [S, pred_len, 2]
    tokens = torch.cat(tok_list)
    light = torch.zeros((tokens.shape[0], 1), device=dev)
    return tokens, torch.cat(tp_list), light, torch.from_numpy(np.concatenate(wp_list)).to(dev)


def plant_bc_step(model: PlanTModel, opt, tokens, target, light, wp_labels) -> torch.Tensor:
    """One behaviour-cloning step: the L1 mean over the predicted waypoints
    (LiDAR offset included), its gradients, one optimizer step. Returns the
    loss (not synchronised)."""
    loss = (model(tokens, target, light)["pred_wp"] - wp_labels).abs().mean()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss


def fit_plant(model: PlanTModel, dataset, lr: float = 1e-4, epochs: int = 10,
              batch_size: int = 64, seed: int = 0):
    """L1 waypoint behaviour cloning (lit_module.py training_step), in
    place. Each epoch visits `np.random.default_rng(seed).permutation(N)`
    in batches of `batch_size`, the remainder dropped, so that both
    packages draw the same batches. No dropout runs (the JAX fit applies
    the model deterministically). Returns (model, the mean loss of each
    epoch)."""
    tokens, targets, light, wps = dataset
    N = tokens.shape[0]
    opt = torch.optim.AdamW(model.parameters(), lr=lr, **ADAMW)
    rng = np.random.default_rng(seed)
    losses = []
    nb = max(N // batch_size, 1)
    for _ in range(epochs):
        order = rng.permutation(N)
        ep_loss = 0.0
        for b in range(nb):
            ix = torch.from_numpy(order[b * batch_size:(b + 1) * batch_size]).to(tokens.device)
            ep_loss += plant_bc_step(model, opt, tokens[ix], targets[ix], light[ix],
                                     wps[ix]).item()
        losses.append(ep_loss / nb)
    return model, losses


@torch.no_grad()
def plant_attn_scores(model: PlanTModel, spec: ScenarioSpec, state: SimState) -> torch.Tensor:
    """[S, A] per-agent relevance: the PlanT CLS attention over the vehicle
    tokens, scattered back to the agents' slots (-inf for agents without a
    token). The JAX package's `.at[].max` into -inf is a scatter-reduce
    "amax" that keeps the initial -inf."""
    S, A = state.alive.shape
    tokens, target, light, veh_idx = build_plant_tokens(spec, state, return_vehicle_index=True)
    att = model(tokens, target, light)["attn_scores"][:, :MAX_VEHICLE_TOKENS]
    scores = torch.full((S, A), -torch.inf, device=att.device)
    return scores.scatter_reduce(
        1, torch.clamp(veh_idx, min=0), torch.where(veh_idx >= 0, att, -torch.inf),
        "amax", include_self=True,
    )


def make_attn_scores_fn(model: PlanTModel, spec: ScenarioSpec):
    """`attn_scores_fn(state) -> [S, A]` for attn_recognize_cbvs (the model
    holds its weights, where the JAX package passes params)."""
    return lambda state: plant_attn_scores(model, spec, state)


def load_plant_params(path: str) -> dict:
    """A PlanT npz in the JAX package's flat-key format (either package's
    `save_params_npz`) as nested numpy params."""
    return load_params_npz(path)


def load_plant_weights(model: PlanTModel, path: str) -> PlanTModel:
    """Fill `model` from a PlanT npz, strictly: every key used, every shape
    matching (the npz's dims must be the model's)."""
    load_jax_params(model, flatten_params(load_plant_params(path)))
    return model


def main(argv=None):
    """Fit PlanT (PlanT_medium by default: dim 512, 8 layers, 8 heads; the
    npz must match the ego config it is loaded into) on a collect_data
    HDF5 file and save its npz. The weights start from
    `init_plant_weights` on a CPU generator seeded 0, at flax's scales but
    not the JAX package's PRNGKey(0) draws. Returns the epoch losses."""
    import argparse

    from ...rl.collect import CollectBuffer

    p = argparse.ArgumentParser("train_plant")
    p.add_argument("h5")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--out", default="plant_params.npz")
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    dataset = plant_bc_dataset(CollectBuffer.load(args.h5), device=device)
    model = PlanTModel(dim=args.dim, num_layers=args.num_layers, num_heads=args.num_heads)
    init_plant_weights(model, torch.Generator().manual_seed(0)).to(device)
    _, losses = fit_plant(model, dataset, lr=args.lr, epochs=args.epochs)
    print("losses:", [round(x, 4) for x in losses])
    save_plant_params(model, args.out)
    print("saved", args.out)
    return losses


if __name__ == "__main__":
    main()
