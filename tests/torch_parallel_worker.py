"""One rank of the port's 2-rank gloo tests on the CPU
(tests/test_torch_parallel.py), and the scenes and batches that those
tests also build in one process. Imports neither jax nor rift_tpu.

    python tests/torch_parallel_worker.py <case> <port> <rank> <out_dir>

`case` is `helpers`, `runner` or `fit`. Each rank joins a group of two over
127.0.0.1:<port> with one torch thread, checks what it can alone, and
writes its results to <out_dir>/<case>_<rank>.pt.
"""

import os
import sys

import torch

S, A, C, SEED = 8, 6, 2, 3  # the JAX package's test_parallel.py runner


def runner_config(**kw):
    from rift_tpu_torch.rl import TrainConfig
    from rift_tpu_torch.runner import RunnerConfig

    kw = {"buffer_capacity": 32, **kw}
    return RunnerConfig(num_scenarios=S, num_agents=A, max_cbvs=C, encoder_depth=1,
                        decoder_depth=1, seed=SEED,
                        train=TrainConfig(epochs=1, warmup_epochs=1, batch_size=8), **kw)


def small_town():
    from rift_tpu_torch.map import make_grid_town

    return make_grid_town(blocks=1, num_lanes=1, device="cpu")


def runner_run(runner, ticks=5):
    """`rollout_chunk` for `ticks` from the runner's first reset, then one
    eval episode of 20 ticks in chunks of 5: the chunk's (pos,
    driven_meters), and the episode's final (pos, driven_meters), of this
    process's scenarios."""
    from rift_tpu_torch.rollout import rollout_chunk

    state, crit, spec = runner.init_params()
    state, crit, _ = rollout_chunk(runner.model, runner.tmap, spec, state, crit, max_cbvs=C,
                                   num_steps=ticks, tick=0)
    chunk = (state.pos, crit.driven_meters)
    runner.cfg.max_episode_ticks = 20
    state, crit, _ = runner.run_episode(train=False, chunk=5)
    return chunk, (state.pos, crit.driven_meters)


def fit_batch():
    """One train batch of S*C samples in f32 (dryrun_multichip's: CBVs
    forced on slot 1, three train ticks), the first half's valid count
    made to differ from the second's, and the seeded f32 model."""
    from rift_tpu_torch.models.pluto import PlutoModel, pluto_cbv_act
    from rift_tpu_torch.scenario import TrafficEnv, wake_all_bvs

    tmap = small_town()
    env = TrafficEnv(tmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=SEED, device="cpu")
    state, crit, spec = env.reset()
    state = wake_all_bvs(state)
    alive = state.alive[:, 1]
    state = state.replace(
        is_cbv=state.is_cbv.clone().index_put_((torch.arange(S), torch.ones(S, dtype=torch.long)),
                                               alive),
        goal=torch.where(alive[:, None, None] & (torch.arange(A) == 1)[None, :, None],
                         state.pos + torch.tensor([60.0, 0.0]), state.goal),
        goal_valid=state.goal_valid | (alive[:, None] & (torch.arange(A) == 1)[None]),
    )
    torch.manual_seed(SEED)
    model = PlutoModel(encoder_depth=1, decoder_depth=1, dtype=torch.float32, device="cpu").eval()
    for _ in range(3):
        res = pluto_cbv_act(model, tmap, spec, state, max_cbvs=C, train=True)
        state, crit = env.step(state, crit, cbv_traj=res["traj"], cbv_traj_mask=res["mask"])
    flat = lambda x: x.reshape((S * C,) + x.shape[2:])
    feats = {g: {k: flat(v) for k, v in d.items()} if isinstance(d, dict) else flat(d)
             for g, d in res["features"].items()}
    valid = flat(res["adv_valid"]).clone()
    valid[:S * C // 4] = False  # scenarios 0 and 1: the first half holds fewer
    batch = {"features": feats, "old_logits": flat(res["old_logits"]),
             "advantage": flat(res["advantage"]), "valid": valid}
    return batch, model.state_dict()


def _helpers(rank):
    from rift_tpu_torch.parallel import (global_mesh, host_local_batch, make_mesh, replicate,
                                         replicate_global, shard_batch)
    from rift_tpu_torch.parallel.mesh import gather_scenarios

    mesh = make_mesh()
    assert mesh.mesh_dim_names == ("scenario",) and mesh.size() == 2
    assert global_mesh().mesh_dim_names == ("scenario",)
    x = {"a": torch.arange(16 * 3).reshape(16, 3), "b": {"c": torch.arange(16.0) * 0.5}}
    sx = shard_batch(x, mesh)
    assert torch.equal(sx["a"], x["a"][8 * rank:8 * rank + 8])
    assert torch.equal(sx["b"]["c"], x["b"]["c"][8 * rank:8 * rank + 8])
    back = gather_scenarios(sx, mesh)
    assert torch.equal(back["a"], x["a"]) and torch.equal(back["b"]["c"], x["b"]["c"])
    mine = {"w": torch.full((4, 4), float(rank + 1)), "m": torch.tensor([rank == 0, True]),
            "h": torch.full((3,), rank + 5, dtype=torch.bfloat16), "i": torch.tensor(rank)}
    rep = replicate(mine, mesh)
    assert torch.equal(rep["w"], torch.ones(4, 4)) and rep["m"].all()
    assert torch.equal(rep["h"], torch.full((3,), 5, dtype=torch.bfloat16))
    assert int(rep["i"]) == 0 and rep["w"].dtype == torch.float32
    local = {"pos": torch.randn(4, 2), "alive": torch.ones(4, dtype=torch.bool)}
    assert host_local_batch(local, mesh) is local
    refused = {}
    try:
        host_local_batch({"pos": torch.zeros(4 + rank, 2)}, mesh)
    except ValueError as e:
        refused["host_local_batch"] = str(e)
    same = {"w": torch.arange(6.0), "k": torch.tensor([1, 2, 3])}
    assert replicate_global(same, mesh) is same
    try:
        replicate_global({"w": torch.arange(6.0), "k": torch.tensor([1, 2, 3 + rank])}, mesh)
    except ValueError as e:
        refused["replicate_global"] = str(e)
    try:
        # a bit apart: -0.0 and 0.0 compare equal, and still differ
        replicate_global({"z": torch.tensor([0.0 if rank == 0 else -0.0])}, mesh)
    except ValueError as e:
        refused["replicate_global_bits"] = str(e)
    return {"refused": refused}


def _runner(rank):
    from rift_tpu_torch.parallel.mesh import gather_scenarios
    from rift_tpu_torch.runner import Runner

    runner = Runner(small_town(), runner_config(), device="cpu")
    assert runner.mesh is not None and runner.env.num_scenarios == S
    chunk, episode = runner_run(runner)
    return {"chunk": gather_scenarios(chunk, runner.mesh),
            "episode": gather_scenarios(episode, runner.mesh),
            "local_scenarios": int(chunk[0].shape[0]),
            "records": [r.__dict__ for r in runner.stats.records]}


def _fit(rank, out_dir):
    """The batch's rows of this rank's scenarios stored as one chunk
    through a sharded Runner (gathered over the ranks), then `fit` on its
    buffer across the ranks."""
    from rift_tpu_torch.models.pluto import PlutoModel
    from rift_tpu_torch.rl import TrainConfig, fit, rift_loss_fn
    from rift_tpu_torch.rl.trainer import loss_and_grads
    from rift_tpu_torch.runner import Runner
    from rift_tpu_torch.utils.tensors import tree_map

    batch, weights = torch.load(os.path.join(out_dir, "fit_inputs.pt"), weights_only=True)
    runner = Runner(small_town(), runner_config(buffer_capacity=S * C), device="cpu")
    model = PlutoModel(encoder_depth=1, decoder_depth=1, dtype=torch.float32,
                       device="cpu").eval()
    model.load_state_dict(weights)
    loss = loss_and_grads(model, rift_loss_fn, batch, list(model.parameters()), runner.mesh)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    rows = S * C // 2
    chunk = tree_map(lambda x: x[None, rank * rows:(rank + 1) * rows], batch)
    runner._store_chunk({**chunk, "sample_valid": torch.ones(1, rows, dtype=torch.bool)})
    cfg = TrainConfig(epochs=2, warmup_epochs=1, batch_size=8)
    losses = fit(model, runner.buffer, rift_loss_fn, cfg, torch.Generator().manual_seed(7),
                 mesh=runner.mesh)
    return {"loss": loss, "grads": grads, "epoch_losses": losses, "buffer": runner.buffer.data,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def main(case, port, rank, out_dir):
    torch.set_num_threads(1)
    from rift_tpu_torch.parallel import init_distributed

    # with no launcher's variables, a process stays alone
    assert init_distributed() is False
    assert init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                            process_id=rank)
    import torch.distributed as dist

    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
    if case == "helpers":
        out = _helpers(rank)
    elif case == "runner":
        out = _runner(rank)
    else:
        out = _fit(rank, out_dir)
    torch.save(out, os.path.join(out_dir, f"{case}_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
