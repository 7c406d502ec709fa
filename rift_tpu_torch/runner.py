"""Top-level runner: the eval and the rollout/train alternation (port of
rift_tpu/runner.py), on one device or data-parallel over the scenarios
across the ranks of a process group. Beside the JAX RunnerConfig's fields
the port's names the ego kind and the walkers and static obstacles of the
scenes; their defaults (the rule ego, none) are what the JAX Runner runs.

Sharded (`shard`, in a process group of n > 1 ranks, one per GPU: see
parallel/): every rank draws the full deterministic reset of all S
scenarios on the host, as one process would, and keeps its block of S/n,
scenes and spec alike; no tick draws a random number (the per-agent bits
live in the state), so each scenario runs as it would alone. The host
decisions that all ranks must take alike are made on all S: an episode
ends when every rank's scenarios are done, and a per-tick train sample
window opens when any CBV acts. Each stored chunk is gathered over the
ranks, so every rank's buffer holds the single-process samples in their
order, and `fit` splits each batch over the ranks (rl/trainer.py). The
statistics are registered from the gathered episode: every rank holds all
S records in scenario order. JAX drops its mesh when S does not divide by
the device count; one process per GPU has no unsharded program to fall
back to short of every rank running all S, so the port raises.

A runner owns the map, the env, the Pluto CBV policy, the ring buffer and
the statistics, and loops episodes. The fine-tune loop fills the buffer
from real train ticks, then `fit` on it, then empties it: buffer full ->
rl.trainer.fit -> ring_reset.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .map.tensor_map import TensorMap
from .models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
from .parallel import make_mesh, replicate, shard_batch
from .parallel.mesh import all_ranks, gather_scenarios
from .rl import TrainConfig, fit, rift_loss_fn, ring_reset
from .rollout import ego_waypoints, flush_pending, rollout_chunk, store_chunk, tick_extras
from .scenario import TrafficEnv
from .scenario.statistics import StatisticsManager
from .utils.device import resolve_device


@dataclass
class RunnerConfig:
    num_scenarios: int = 4
    num_agents: int = 16
    max_cbvs: int = 3
    max_episode_ticks: int = 600
    buffer_capacity: int = 1024
    train: TrainConfig = field(default_factory=TrainConfig)
    seed: int = 0
    encoder_depth: int = 4
    decoder_depth: int = 4
    # data-parallel over the scenario axis across the ranks of a process
    # group (parameters replicated, scenes and fit batches split)
    shard: bool = True
    # frame-invariant token mode: encoders run once per world agent and
    # map lane instead of once per CBV view (default: legacy per-CBV tokens)
    canonical: bool = False
    ego: str = "rule"  # rollout.rollout_chunk's ego kind: rule, pdm or expert
    num_walkers: int = 0  # crossing pedestrians per scenario
    num_statics: int = 0  # static obstacles per scenario


class Runner:
    def __init__(self, tmap: TensorMap, cfg: RunnerConfig | None = None, device=None):
        self.cfg = cfg or RunnerConfig()
        self.device = resolve_device(device)
        self.tmap = tmap
        self.mesh = None
        if self.cfg.shard and dist.is_initialized() and dist.get_world_size() > 1:
            n = dist.get_world_size()
            if self.cfg.num_scenarios % n:
                raise ValueError(
                    f"{self.cfg.num_scenarios} scenarios do not split over {n} ranks: "
                    "each rank would have to run all of them (shard=False does that)")
            self.mesh = make_mesh(n)
        self.env = TrafficEnv(
            tmap, num_scenarios=self.cfg.num_scenarios, num_agents=self.cfg.num_agents,
            max_cbvs=self.cfg.max_cbvs, seed=self.cfg.seed, num_walkers=self.cfg.num_walkers,
            num_statics=self.cfg.num_statics, device=self.device,
        )
        self.model = self._seeded_model()
        self.buffer = None
        self.stats = StatisticsManager()
        self.train_rounds = 0
        self.gen = torch.Generator(self.device).manual_seed(self.cfg.seed)
        self._map_tok = None

    def _seeded_model(self) -> PlutoModel:
        """Fresh planner weights from the config's seed (the global torch
        generator is left as it was); sharded, rank 0's."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.cfg.seed)
            model = PlutoModel(
                encoder_depth=self.cfg.encoder_depth, decoder_depth=self.cfg.decoder_depth,
                device=self.device,
            ).eval()
        if self.mesh is not None:
            model.load_state_dict(replicate(model.state_dict(), self.mesh))
        return model

    def init_params(self):
        """Fresh seeded weights and new scenes: (state, crit, spec)."""
        self.model = self._seeded_model()
        self._map_tok = None
        return self._reset()

    def _reset(self):
        """New scenes, this rank's block of them when sharded."""
        state, crit, spec = self.env.reset()
        if self.mesh is None:
            return state, crit, spec
        state, crit, spec = shard_batch((state, crit, spec), self.mesh)
        self.env.spec = spec
        return state, crit, spec

    def _all_done(self, crit) -> bool:
        done = self.env.all_done(crit)
        return done if self.mesh is None else all_ranks(done, self.mesh)

    def _any_acts(self, mask) -> bool:
        """Whether a CBV of any scenario (of any rank) acts this tick."""
        acts = bool(mask.any())
        return acts if self.mesh is None else not all_ranks(not acts, self.mesh)

    def _gather(self, tree, dim: int = 0):
        """The whole batch from each rank's block (identity unsharded)."""
        return tree if self.mesh is None else gather_scenarios(tree, self.mesh, dim)

    def _map_tokens(self):
        """Canonical per-lane map tokens, computed once per weight change
        (`fit` updates the model in place, so it clears them); None on
        legacy tokens."""
        if not self.cfg.canonical:
            return None
        if self._map_tok is None:
            self._map_tok = canonical_map_tokens(self.model, self.tmap)
        return self._map_tok

    def run_episode(self, train: bool = False, collect=None, chunk: int = 10):
        """One batched episode -> (state, crit, spec), of this rank's
        scenarios when sharded. Ticks run in chunks of `chunk`
        (rollout_chunk) unless a per-tick `collect(state, act)` callback
        needs the intermediate states."""
        state, crit, spec = self._reset()
        C = self.cfg.max_cbvs
        if collect is not None:
            pending = []
            for _ in range(self.cfg.max_episode_ticks):
                ego_traj = ego_waypoints(self.cfg.ego, self.tmap, spec, state)
                res = pluto_cbv_act(
                    self.model, self.tmap, spec, state, max_cbvs=C, train=train,
                    canonical=self.cfg.canonical, map_tok=self._map_tokens(),
                )
                collect(state, res)
                state, crit = self.env.step(
                    state, crit, cbv_traj=res["traj"], cbv_traj_mask=res["mask"],
                    ego_traj=ego_traj,
                )
                if train and self._any_acts(res["mask"]):
                    pending.append(tick_extras(self.tmap, res, state, crit))
                    if len(pending) >= 16:
                        flush_pending(self._store_chunk, pending)
                if self._all_done(crit):
                    break
            if train:
                flush_pending(self._store_chunk, pending)
        else:
            for _ in range(max(self.cfg.max_episode_ticks // chunk, 1)):
                state, crit, extras = rollout_chunk(
                    self.model, self.tmap, spec, state, crit, max_cbvs=C,
                    num_steps=chunk, train=train, ego=self.cfg.ego,
                    canonical=self.cfg.canonical, map_tok=self._map_tokens(),
                    tick=self.env.advance(chunk),
                )
                if extras is not None:
                    self._store_chunk(extras)
                if self._all_done(crit):
                    break
        self.stats.register_episode(*self._gather((crit, state, spec)))
        return state, crit, spec

    def _store_chunk(self, extras):
        """Append a chunk's [K, B] samples; sharded, all ranks' B columns
        in scenario order, so every rank's buffer is the single-process one."""
        self.buffer = store_chunk(self.buffer, self._gather(extras, dim=1),
                                  self.cfg.buffer_capacity)

    def train_cbv(self, num_episodes: int = 10, chunk: int = 10):
        """Closed-loop RIFT fine-tuning: episodes of train ticks; each time
        the buffer is full, one `fit` round on it. Returns the rounds'
        epoch losses."""
        losses_log = []
        for _ in range(num_episodes):
            self.run_episode(train=True, chunk=chunk)
            if self.buffer is not None and self.buffer.full:
                losses_log.append(fit(
                    self.model, self.buffer, rift_loss_fn, self.cfg.train, self.gen,
                    round_idx=self.train_rounds, mesh=self.mesh,
                ))
                self._map_tok = None
                self.train_rounds += 1
                ring_reset(self.buffer)
        return losses_log

    def eval(self, num_episodes: int = 3, chunk: int = 10):
        for _ in range(num_episodes):
            self.run_episode(train=False, chunk=chunk)
        return self.stats.compute_global_statistics()

    def collect_data(self, num_episodes: int = 1):
        """Offline dataset collection: a list of per-tick dicts (numpy) of
        the agents' states and the CBVs' planned waypoints (of all S
        scenarios on every rank when sharded)."""
        dataset = []

        def collect(state, res):
            tick = self._gather({
                "pos": state.pos, "heading": state.heading, "speed": state.speed,
                "is_cbv": state.is_cbv, "alive": state.alive, "cbv_traj": res["traj"],
            })
            dataset.append({k: v.cpu().numpy() for k, v in tick.items()})

        for _ in range(num_episodes):
            self.run_episode(train=False, collect=collect)
        return dataset
