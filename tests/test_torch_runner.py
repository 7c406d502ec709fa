"""The port's fine-tune tick signals, statistics and Runner, on the CPU.

Against the JAX package, on given inputs (numpy-seeded agents on the small
grid town's lanes, fake policy outputs, seeded criteria):
`rollout.tick_extras` with `rl.evaluator.executed_cbv_reward`,
`rollout.flush_pending` with `_chunk_returns` over four ticks, and
`StatisticsManager.register_episode` / `compute_global_statistics`.
Tolerances: integer and bool outputs exactly; rewards and returns 1e-5
(a handful of f32 products, and the 0.98-discounted sums of four ticks);
statistics 1e-6 relative (f32 sums read into Python floats; the
Shapiro-Wilk samples come from a seeded numpy generator on equal
histograms).

The Runner on the port's side only (the JAX train rollout is not compiled
here: its 40-step re-tracking scan alone costs ~30 s): `eval` returns
global statistics of its scenes, and `train_cbv` fills the buffer from
real train ticks (CBVs come from recognition after tick 25), runs `fit`,
moves `pi_head` and nothing else, and recomputes the map tokens;
`collect_data` steps tick by tick, and `init_params` restores the seeded
weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map.tensor_map import TensorMap as JaxTensorMap
from rift_tpu.rollout import flush_pending as jax_flush_pending
from rift_tpu.rollout import tick_extras as jax_tick_extras
from rift_tpu.scenario.criteria import init_criteria as jax_init_criteria
from rift_tpu.scenario.statistics import StatisticsManager as JaxStatistics
from rift_tpu.sim.state import ScenarioSpec as JaxSpec
from rift_tpu.sim.state import init_sim_state_host as jax_init_state
from rift_tpu_torch.rl import TrainConfig
from rift_tpu_torch.rollout import flush_pending, tick_extras
from rift_tpu_torch.runner import Runner, RunnerConfig
from rift_tpu_torch.scenario.statistics import StatisticsManager
from rift_tpu_torch.map import make_grid_town
from torch_parity import crit_from_jax, one_torch_thread, spec_from_jax, state_from_jax

S, A, C, R, M = 2, 8, 2, 3, 4


@pytest.fixture(scope="module")
def maps():
    """The small grid town: the port's build, and the JAX package's
    TensorMap holding the same arrays (the two grid towns agree bit for bit,
    tests/test_torch_map.py)."""
    tmap = make_grid_town(blocks=1, num_lanes=2, device="cpu")
    as_jax = lambda a: jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
    jmap = JaxTensorMap(**{
        f.name: as_jax(getattr(tmap, f.name).numpy()) for f in dataclasses.fields(JaxTensorMap)
    })
    return jmap, tmap


def _given_state(jmap, r):
    """Agents on random valid lanes near their centerlines, with random
    kinematics and events (numpy, as the JAX package's host state)."""
    lanes = r.choice(np.flatnonzero(np.asarray(jmap.valid)), (S, A))
    vi = r.integers(0, jmap.centerline.shape[1], (S, A))
    return jax_init_state(S, A).replace(
        pos=(np.asarray(jmap.centerline)[lanes, vi] + r.normal(0, 0.8, (S, A, 2))).astype(np.float32),
        heading=(np.asarray(jmap.headings)[lanes, vi] + r.normal(0, 0.2, (S, A))).astype(np.float32),
        lane=lanes.astype(np.int32),
        speed=r.uniform(0, 10, (S, A)).astype(np.float32),
        accel=r.normal(0, 2, (S, A)).astype(np.float32),
        yaw_rate=r.normal(0, 0.3, (S, A)).astype(np.float32),
        collision=r.random((S, A)) < 0.2,
        offroad=r.random((S, A)) < 0.2,
        is_cbv=r.random((S, A)) < 0.5,
        alive=np.ones((S, A), bool),
    )


def _given_act(r):
    """A train-mode act's outputs: slots (some padded), features and the
    GRPO signals."""
    slots = np.where(r.random((S, C)) < 0.8, r.integers(1, A, (S, C)), -1).astype(np.int32)
    f = lambda *s: r.normal(size=(S, C) + s).astype(np.float32)
    return {
        "cbv_slots": slots,
        "features": {"agent": {"x": f(3)}, "y": f(2)},
        "old_logits": f(R, M), "advantage": f(R, M), "adv_valid": r.random((S, C, R, M)) < 0.7,
        "rollout_return": f(R, M), "chosen_idx": r.integers(0, R * M, (S, C)).astype(np.int32),
        "teacher_speed": f(), "exec_speed": f(), "teacher_pos": f(2), "teacher_traj": f(80, 2),
        "value": f(),
    }


def _tree(x, fn):
    return {k: _tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _assert_tree_close(ref, got, atol, name=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), (name, set(ref) ^ set(got))
        for k in ref:
            _assert_tree_close(ref[k], got[k], atol, f"{name}.{k}")
        return
    a, b = np.asarray(ref), got.numpy()
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, atol=atol, rtol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)


def test_tick_signals_and_chunk_returns_match(maps):
    """Four ticks of given acts and post-step states through tick_extras
    (executed_cbv_reward, teacher reward, done flags, sample validity),
    then flush_pending (_chunk_returns: discounted and shaped returns, GAE
    and its validity)."""
    jmap, tmap = maps
    r = np.random.default_rng(4)
    jpend, tpend = [], []
    jax_extras = jax.jit(jax_tick_extras)
    for _ in range(4):
        state, act = _given_state(jmap, r), _given_act(r)
        crit = jax_init_criteria(S, A).replace(done=r.random(S) < 0.3)
        ref = jax_extras(jmap, _tree(act, jnp.asarray), state, crit)
        got = tick_extras(
            tmap, _tree(act, lambda a: torch.from_numpy(a).long() if a.dtype == np.int32
                        else torch.from_numpy(a)),
            state_from_jax(state), crit_from_jax(crit),
        )
        _assert_tree_close(ref, got, 1e-5)
        assert np.asarray(ref["reward"]).std() > 0.1 and np.asarray(ref["done"]).any()
        jpend.append(ref)
        tpend.append(got)
    stored = {}
    jax_flush_pending(lambda x: stored.setdefault("ref", x), jpend)
    flush_pending(lambda x: stored.setdefault("got", x), tpend)
    assert not jpend and not tpend
    _assert_tree_close(stored["ref"], stored["got"], 1e-5)


def test_statistics_match():
    """register_episode on seeded criteria (counts, sums, histograms),
    cursors and route lengths, then the global row."""
    r = np.random.default_rng(6)
    crit = jax_init_criteria(S, A)
    kw = {}
    for f in dataclasses.fields(crit):
        a = np.asarray(getattr(crit, f.name))
        if a.dtype == bool:
            kw[f.name] = r.random(a.shape) < 0.4
        elif a.dtype.kind == "i":
            kw[f.name] = r.integers(0, 30, a.shape).astype(a.dtype)
        else:
            kw[f.name] = r.uniform(0, 50, a.shape).astype(a.dtype)
    crit = crit.replace(**kw)
    state = jax_init_state(S, A).replace(
        ego_route_cursor=r.uniform(0, 300, S).astype(np.float32),
        tick=r.integers(1, 600, S).astype(np.int32),
    )
    spec = JaxSpec(
        ego_route=np.zeros((S, 4, 3), np.float32),
        ego_route_len=r.integers(100, 400, S).astype(np.int32),
        route_road_ids=np.zeros((S, 2), np.int32),
        route_lane_ids=np.zeros((S, 2), np.int32),
        ego_target_speed=np.full(S, 8.0, np.float32),
        timeout_ticks=np.full(S, 600, np.int32),
    )
    jstats, tstats = JaxStatistics(), StatisticsManager()
    for _ in range(2):
        jstats.register_episode(crit, state, spec)
        tstats.register_episode(crit_from_jax(crit), state_from_jax(state), spec_from_jax(spec))
    assert len(tstats.records) == 2 * S
    for ref, got in zip(jstats.records, tstats.records):
        ref, got = dataclasses.asdict(ref), dataclasses.asdict(got)
        assert ref.keys() == got.keys()
        for k in ref:
            if isinstance(ref[k], float):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
            elif k == "sums":
                for m in ref[k]:
                    np.testing.assert_allclose(got[k][m], ref[k][m], rtol=1e-6, err_msg=m)
            else:
                assert got[k] == ref[k], k
    ref, got = (dataclasses.asdict(s.compute_global_statistics()) for s in (jstats, tstats))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert np.isfinite(got["sw_speed"]) and got["total_routes"] == 2 * S


def test_runner_eval_and_train_cbv(maps):
    _, tmap = maps
    cfg = RunnerConfig(
        num_scenarios=S, num_agents=10, max_cbvs=C, max_episode_ticks=30, buffer_capacity=4,
        encoder_depth=1, decoder_depth=1, canonical=True,
        # two steps of one sample batch each: the first at lr 0 (warm-up)
        train=TrainConfig(epochs=2, warmup_epochs=1, batch_size=4),
    )
    runner = Runner(tmap, cfg, device="cpu")
    runner.cfg.max_episode_ticks = 10  # eval: one short episode before any CBV
    stats = runner.eval(num_episodes=1)
    assert stats.total_routes == S and runner.buffer is None
    assert 0.0 < stats.avg_route_completion <= 100.0
    assert [r.duration_ticks for r in runner.stats.records] == [10] * S
    runner.cfg.max_episode_ticks = 30  # train: CBVs from tick 26 fill the buffer

    tok = runner._map_tokens()
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    losses = runner.train_cbv(num_episodes=1)
    assert runner.train_rounds == 1 and len(losses) == 1 and np.isfinite(losses[0]).all()
    assert runner.buffer.size == 0  # emptied after the round
    moved = [n for n, p in runner.model.named_parameters() if not torch.equal(p, before[n])]
    assert moved and all(n.startswith("planning_decoder.pi_head") for n in moved)
    assert runner._map_tok is None  # the cache is invalidated by fit
    assert torch.equal(runner._map_tokens(), tok)  # the map encoder did not train

    # the per-tick branch of run_episode, and fresh seeded weights
    runner.cfg.max_episode_ticks = 3
    data = runner.collect_data(num_episodes=1)
    assert len(data) == 3 and data[0]["pos"].shape == (S, 10, 2)
    assert data[0]["cbv_traj"].shape[:2] == (S, 10) and data[2]["is_cbv"].dtype == bool
    state, crit, spec = runner.init_params()
    fresh = Runner(tmap, cfg, device="cpu").model
    assert all(torch.equal(p, q) for p, q in zip(runner.model.parameters(), fresh.parameters()))
    assert runner._map_tok is None and int(state.tick.max()) == 0 and not bool(crit.done.any())
