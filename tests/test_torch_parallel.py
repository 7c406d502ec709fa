"""Data parallelism over the scenario axis (rift_tpu_torch/parallel/, the
Runner's shard path, `fit` across ranks), each test one group of two gloo
ranks on the CPU (tests/torch_parallel_worker.py, one torch thread, each
process under its own timeout), held against the port's own
single-process run in this process. The single-process port is held
against the JAX package by test_torch_runner.py and test_torch_train.py,
and the JAX package's multi-process check is `slow`, so no JAX program is
compiled here.

Tolerances, the JAX package's (tests/test_parallel.py): rollout fields at
rtol 1e-4 and atol 1e-4 (they come out equal here: each scenario runs
the same ops on its rank); the gradient of a batch split over the ranks at
rtol 1e-3 and atol 1e-7; a fit round's epoch losses at rtol 5e-2. The
sharded `Runner.train_cbv` (its episode, stored chunks and fit round) runs
on the card, chip_smoke phase 19.
"""

import os
import socket
import subprocess
import sys

import torch

import torch_parallel_worker as worker
from rift_tpu_torch.parallel.mesh import tree_leaves
from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(case, out_dir):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RIFT_") and k not in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                                      "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"), case,
         str(port), str(rank), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO, text=True)
        for rank in range(2)]


def _join_ranks(procs, case, out_dir):
    """Each rank's results; a rank that fails or outlives its timeout fails
    the test (and the other is stopped)."""
    try:
        for p in procs:
            log, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, f"{case} rank failed:\n{log[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(os.path.join(out_dir, f"{case}_{r}.pt"), weights_only=False)
            for r in range(2)]


def test_parallel_helpers(tmp_path):
    """The seven names across two ranks: `init_distributed` does nothing
    without a launcher's variables and joins with explicit ones; the mesh
    is 1-D and named ("scenario",); `shard_batch` keeps rank r's block [r*S/n,
    (r+1)*S/n), JAX's P("scenario") block of device r, and gathering the
    blocks gives the batch back; `replicate` broadcasts rank 0's tensors
    (f32, bool, bf16, int); `host_local_batch` keeps each rank's shard and
    refuses shards of different leading dims; `replicate_global` returns
    equal tensors and refuses tensors that differ between the ranks, also
    by one bit (0.0 against -0.0)."""
    results = _join_ranks(_start_ranks("helpers", tmp_path), "helpers", tmp_path)
    for res in results:
        refused = res["refused"]
        assert "[[4], [5]]" in refused["host_local_batch"]
        assert "leaves [1] differ" in refused["replicate_global"]
        assert "leaves [0] differ" in refused["replicate_global_bits"]


def test_sharded_runner_matches_one_process(tmp_path):
    """A Runner at S=8 on two ranks (4 scenarios a rank) against the same
    Runner in one process (JAX's test_sharded_rollout_matches_unsharded
    and test_runner_episode_under_mesh): `rollout_chunk` for 5 ticks from
    the first reset, then an eval episode of 20 ticks. Positions and
    driven meters, gathered, match, and both ranks hold the episode's 8
    records, in scenario order, equal to the one process's."""
    procs = _start_ranks("runner", tmp_path)
    from rift_tpu_torch.runner import Runner

    one = Runner(worker.small_town(), worker.runner_config(), device="cpu")
    assert one.mesh is None
    chunk, episode = worker.runner_run(one)
    records = [r.__dict__ for r in one.stats.records]
    assert len(records) == worker.S
    for res in _join_ranks(procs, "runner", tmp_path):
        assert res["local_scenarios"] == worker.S // 2
        for got, want in zip(res["chunk"] + res["episode"], chunk + episode):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert res["records"] == records


def test_fit_across_ranks_matches_one_process(tmp_path):
    """`fit` across two ranks against one process (dryrun_multichip's
    batch: CBVs forced on slot 1, three f32 train ticks at S=8), on a batch
    whose two halves hold different valid counts (24 and 48 candidates):
    the gradient summed over the ranks is the one-process gradient, where
    a mean of the two halves' mean losses is not. Each rank stores its
    scenarios' rows as a chunk through a sharded Runner, which gathers
    them: both buffers hold the one process's batch, in its order. A whole
    fit round on them (2 epochs of 2 steps) gives the one process's epoch
    losses and moves pi_head, and the parameters are the same bits on both
    ranks."""
    from rift_tpu_torch.models.pluto import PlutoModel
    from rift_tpu_torch.rl import TrainConfig, fit, rift_loss_fn, ring_append, ring_init
    from rift_tpu_torch.rl.trainer import loss_and_grads
    from rift_tpu_torch.utils.tensors import tree_map

    batch, weights = worker.fit_batch()
    half = worker.S * worker.C // 2
    assert int(batch["valid"][:half].sum()) != int(batch["valid"][half:].sum())
    torch.save((batch, weights), tmp_path / "fit_inputs.pt")
    procs = _start_ranks("fit", tmp_path)

    model = PlutoModel(encoder_depth=1, decoder_depth=1, dtype=torch.float32,
                       device="cpu").eval()
    model.load_state_dict(weights)
    grads = lambda: {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters()}
    loss = loss_and_grads(model, rift_loss_fn, batch, list(model.parameters()))
    want = grads()
    model.zero_grad()
    halves = [tree_map(lambda x: x[:half], batch), tree_map(lambda x: x[half:], batch)]
    (0.5 * (rift_loss_fn(model, halves[0]) + rift_loss_fn(model, halves[1]))).backward()
    mean_of_means = grads()
    close = lambda g: all(torch.allclose(g[n], want[n], rtol=1e-3, atol=1e-7) for n in want)
    assert not close(mean_of_means)

    buf = ring_init(tree_map(lambda x: x[0], batch), capacity=2 * half)
    ring_append(buf, batch, torch.ones(2 * half, dtype=torch.bool))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = TrainConfig(epochs=2, warmup_epochs=1, batch_size=half)
    losses = fit(model, buf, rift_loss_fn, cfg, torch.Generator().manual_seed(7))

    a, b = _join_ranks(procs, "fit", tmp_path)
    for res in (a, b):
        for got, want_row in zip(tree_leaves(res["buffer"]), tree_leaves(buf.data)):
            assert torch.equal(got, want_row)
        torch.testing.assert_close(res["loss"], loss, rtol=1e-3, atol=1e-7)
        for n, g in want.items():
            torch.testing.assert_close(res["grads"][n], g, rtol=1e-3, atol=1e-7)
        torch.testing.assert_close(torch.tensor(res["epoch_losses"]), torch.tensor(losses),
                                   rtol=5e-2, atol=1e-8)
    moved = sum((a["params"][n] - before[n]).abs().sum().item()
                for n in before if n.startswith("planning_decoder.pi_head"))
    assert moved > 0.0
    for n, p in a["params"].items():
        assert torch.equal(p, b["params"][n]), n
