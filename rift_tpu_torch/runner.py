"""Top-level runner: the eval and the rollout/train alternation (port of
rift_tpu/runner.py, on one device; the scenario-sharded mesh path comes
with multi-GPU). Beside the JAX RunnerConfig's fields the port's names the
ego kind and the walkers and static obstacles of the scenes; their
defaults (the rule ego, none) are what the JAX Runner runs.

A runner owns the map, the env, the Pluto CBV policy, the ring buffer and
the statistics, and loops episodes. The fine-tune loop fills the buffer
from real train ticks, then `fit` on it, then empties it: buffer full ->
rl.trainer.fit -> ring_reset.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .map.tensor_map import TensorMap
from .models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
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
        generator is left as it was)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.cfg.seed)
            return PlutoModel(
                encoder_depth=self.cfg.encoder_depth, decoder_depth=self.cfg.decoder_depth,
                device=self.device,
            ).eval()

    def init_params(self):
        """Fresh seeded weights and new scenes: (state, crit, spec)."""
        self.model = self._seeded_model()
        self._map_tok = None
        return self.env.reset()

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
        """One batched episode -> (state, crit, spec). Ticks run in chunks
        of `chunk` (rollout_chunk) unless a per-tick `collect(state, act)`
        callback needs the intermediate states."""
        state, crit, spec = self.env.reset()
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
                if train and bool(res["mask"].any()):
                    pending.append(tick_extras(self.tmap, res, state, crit))
                    if len(pending) >= 16:
                        flush_pending(self._store_chunk, pending)
                if self.env.all_done(crit):
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
                if self.env.all_done(crit):
                    break
        self.stats.register_episode(crit, state, spec)
        return state, crit, spec

    def _store_chunk(self, extras):
        self.buffer = store_chunk(self.buffer, extras, self.cfg.buffer_capacity)

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
                    round_idx=self.train_rounds,
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
        the agents' states and the CBVs' planned waypoints."""
        dataset = []

        def collect(state, res):
            dataset.append({
                "pos": state.pos.cpu().numpy(),
                "heading": state.heading.cpu().numpy(),
                "speed": state.speed.cpu().numpy(),
                "is_cbv": state.is_cbv.cpu().numpy(),
                "alive": state.alive.cpu().numpy(),
                "cbv_traj": res["traj"].cpu().numpy(),
            })

        for _ in range(num_episodes):
            self.run_episode(train=False, collect=collect)
        return dataset
