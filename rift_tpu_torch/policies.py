"""Policy registries: the CBV and ego zoos (port of rift_tpu/policies.py:
the Pluto family, the classic PPO CBVs (`ppo`, `frea`, `fppo_rs`), and
the rule, PDM-Lite, expert, expert-disturb, PlanT, PPO and E2E camera
egos: `vad`, `uniad`, `sparsedrive`).

`CBV_POLICY_LIST` and `EGO_POLICY_LIST` hold the JAX package's keys;
asking for another raises a KeyError that names them. A policy owns an
`nn.Module` (its weights) and an explicit `torch.Generator`. The fine-tuned Pluto variants share
one rollout driver (models/pluto/policy.py:pluto_cbv_act) and differ in
the loss their `train_round` hands to rl.trainer.fit and in the
parameters it trains. Pluto runs on the legacy per-CBV tokens, the JAX
package's default, unless its config sets `canonical_tokens` (the
frame-invariant tokens, with the map tokens computed once per weight
change). The two conventions share one parameter tree but not trained
weights. An ego's `act` gives its waypoints [S, T, 2] (the rl-type `ppo`
ego: a dict with raw controls `ctrl` [S, 3]) for run.py's per-tick loop;
the fused loop computes the egos of FUSED_EGO_KIND inside rollout_chunk.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Callable

import torch

from .ego.pdm_ego import pdm_ego_waypoints
from .ego.rule_ego import rule_ego_waypoints
from .models.e2e import E2EModel, bc_train, e2e_ego_waypoints, init_e2e_weights
from .models.plant import PlanTModel, init_plant_weights, plant_ego_waypoints
from .models.plant.train import load_plant_weights
from .models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
from .rl import (
    TrainConfig,
    fit,
    grpo_loss,
    masked_log_softmax,
    reinforce_loss,
    rift_loss,
    ring_reset,
    sft_loss,
    smooth_l1,
)
from .rl.classic import ClassicPPO, cbv_normal_obs, ego_normal_obs, rl_action_to_control
from .rollout import store_chunk
from .scenario.recognition import cbv_slot_assignment
from .utils.checkpoint import CheckpointManager
from .utils.params_io import flatten_params, load_jax_params, load_params_npz
from .utils.params_io import save_params_npz


class _Registry(dict):
    """A policy zoo: an unknown key raises a KeyError naming the known ones."""

    def __init__(self, kind: str, entries: dict):
        super().__init__(entries)
        self.kind = kind

    def __missing__(self, key):
        raise KeyError(f"no {self.kind} policy {key!r} (the {self.kind} policies: "
                       f"{', '.join(sorted(self))})")


# ---------------------------------------------------------------------------
# CBV policies
# ---------------------------------------------------------------------------
class DummyPolicy:
    """'standard': no adversary; every background vehicle stays on the IDM
    autopilot."""

    name = "standard"
    type = "unlearnable"

    def __init__(self, tmap, cfg=None):
        self.tmap = tmap

    def act(self, spec, state, train=False):
        S, A = state.alive.shape
        dev = state.pos.device
        return {
            "traj": torch.zeros((S, A, 1, 2), device=dev),
            "mask": torch.zeros((S, A), dtype=torch.bool, device=dev),
        }

    def train_round(self, *a, **k):
        return []


def _frozen_copy(model):
    ref = copy.deepcopy(model)
    for p in ref.parameters():
        p.requires_grad_(False)
    return ref


class PlutoPolicy:
    """Frozen pretrained Pluto ('pluto'), on the map's device, with
    weights made from the config's seed (0 by default; the CLI's `--seed`
    does not reach it, as in the JAX CLI)."""

    name = "pluto"
    type = "il"
    trainable = False
    execute_teacher = False  # the BC pretrain's expert rollouts
    value_head = False  # ppo_pluto's critic

    def __init__(self, tmap, cfg=None, encoder_depth=4, decoder_depth=4, seed=0):
        cfg = cfg or {}
        # frame-invariant tokens; the legacy per-CBV ones by default
        self.canonical = bool(cfg.get("canonical_tokens", False))
        self.tmap = tmap
        self.max_cbvs = cfg.get("max_cbvs", 3)
        seed = cfg.get("seed", seed)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = PlutoModel(
                encoder_depth=cfg.get("encoder_depth", encoder_depth),
                decoder_depth=cfg.get("decoder_depth", decoder_depth),
                value_head=self.value_head,
                device=tmap.device,
            ).eval()
        self._map_tok = self._map_tok_of = None

    def act(self, spec, state, train=False):
        return pluto_cbv_act(
            self.model, self.tmap, spec, state, max_cbvs=self.max_cbvs,
            train=train and self.trainable, canonical=self.canonical,
            map_tok=self.map_tokens(), execute_teacher=self.execute_teacher,
        )

    def map_tokens(self):
        """Canonical per-lane map tokens, computed once per weight change
        (every update of the model in place clears them) and per map (a
        route run swaps the policy's `tmap` every episode); None on legacy
        tokens."""
        if not self.canonical:
            return None
        if self._map_tok is None or self._map_tok_of is not self.tmap:
            self._map_tok = canonical_map_tokens(self.model, self.tmap)
            self._map_tok_of = self.tmap
        return self._map_tok

    def train_round(self, *a, **k):
        return []

    # checkpointing
    def save(self, mgr, episode):
        mgr.save(self.model.state_dict(), episode, name=self.name)

    def load(self, mgr, episode=None):
        state_dict, ep = mgr.restore(episode, name=self.name,
                                     map_location=self.tmap.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
            self._map_tok = None
        return ep

    def load_pretrain(self, npz_path: str):
        """Load a pretrained Pluto npz in the JAX package's format (either
        package's `save_params_npz`). Parameters absent from the file (e.g.
        ppo_pluto's value head) keep their fresh init."""
        load_jax_params(self.model, flatten_params(load_params_npz(npz_path)), strict=False)
        self._map_tok = None

    def save_pretrain(self, npz_path: str):
        save_params_npz(self.model, npz_path)


class _FineTunedPluto(PlutoPolicy):
    """Shared machinery of the fine-tuned family."""

    trainable = True
    buffer_capacity = 4096
    needs_reference = False  # a frozen copy of the pretrain (GRPO's KL)

    def __init__(self, tmap, cfg=None, **kw):
        super().__init__(tmap, cfg, **kw)
        cfg = cfg or {}
        self.buffer = None
        tc = cfg.get("train", TrainConfig())
        if isinstance(tc, dict):  # the JSON configs carry a plain dict
            fields = {f.name for f in dataclasses.fields(TrainConfig)}
            tc = TrainConfig(**{
                k: (tuple(v) if k == "trainable_prefixes" else v)
                for k, v in tc.items() if k in fields
            })
        self.train_cfg = tc
        self.buffer_capacity = cfg.get("buffer_capacity", self.buffer_capacity)
        self.train_rounds = 0
        self.ref_model = None

    def store_chunk(self, extras):
        """Append [K, B, ...] chunk samples to the ring buffer."""
        self.buffer = store_chunk(self.buffer, extras, self.buffer_capacity)

    def buffer_full(self):
        return self.buffer is not None and bool(self.buffer.full)

    def _forward(self, model, batch):
        """The model on a buffered batch's per-sample features, legacy or
        canonical (the auxiliary agent-prediction head skipped: no loss
        reads it), and the reference lines' padding."""
        out = model({**batch["features"], "no_aux": True})
        return out, ~batch["features"]["reference_line"]["valid_mask"].any(-1)

    def _loss_fn(self, model, batch):
        raise NotImplementedError

    def load_pretrain(self, npz_path: str):
        """The fine-tuned variants also anchor GRPO's KL reference to the
        pretrain."""
        super().load_pretrain(npz_path)
        if self.needs_reference:
            self.ref_model = _frozen_copy(self.model)

    def train_round(self):
        """One `fit` round on the buffer (then emptied), its batches drawn
        from a generator seeded by the round's index (the JAX package's
        `PRNGKey(train_rounds)`); returns the mean loss of each epoch, or []
        with an empty buffer."""
        if self.buffer is None or int(self.buffer.size) == 0:
            return []
        if self.needs_reference and self.ref_model is None:
            warnings.warn(
                f"{self.name} trained without --pretrain: the KL penalty anchors "
                "to the randomly initialised first-update snapshot, not to a "
                "pretrained policy. Pass --pretrain <npz>.",
                stacklevel=2,
            )
            self.ref_model = _frozen_copy(self.model)
        gen = torch.Generator(self.tmap.device).manual_seed(self.train_rounds)
        losses = fit(self.model, self.buffer, self._loss_fn, self.train_cfg, gen,
                     round_idx=self.train_rounds)
        self.train_rounds += 1
        self._map_tok = None
        ring_reset(self.buffer)
        return losses


class RIFTPlutoPolicy(_FineTunedPluto):
    """'rift_pluto': the flagship (dual-clip group-relative objective)."""

    name = "rift_pluto"
    type = "rlft"

    def _loss_fn(self, model, batch):
        out, r_pad = self._forward(model, batch)
        return rift_loss(out["probability"], r_pad, batch["old_logits"],
                         batch["advantage"], batch["valid"])


class GRPOPlutoPolicy(_FineTunedPluto):
    """'grpo_pluto': PPO clip + KL to the frozen pretrain policy."""

    name = "grpo_pluto"
    type = "rlft"
    needs_reference = True

    def _loss_fn(self, model, batch):
        out, r_pad = self._forward(model, batch)
        with torch.no_grad():
            ref_out, _ = self._forward(self.ref_model, batch)
        return grpo_loss(out["probability"], r_pad, batch["old_logits"],
                         ref_out["probability"], batch["advantage"], batch["valid"])


def _candidate_speeds(trajectory, dt: float = 0.1):
    """[bs, R, M] desired speed each candidate implies: mean waypoint
    spacing over the first second / dt."""
    step_d = torch.linalg.norm(torch.diff(trajectory[..., :10, :2], dim=-2), dim=-1)
    return step_d.mean(-1) / dt


TEACHER_HORIZON_STEP = 39  # candidate waypoint compared to the teacher pose
TEACHER_SPEED_WEIGHT = 2.0  # m per (m/s) of speed mismatch in the score


def _teacher_label(prob, r_pad, trajectory, teacher_speed, teacher_pos=None):
    """Flattened R*M teacher index: the candidate matching the privileged
    autopilot's pose and speed. With `teacher_pos` ([bs, 2], the local pose
    the teacher reaches at the 4 s horizon): the argmin over the valid
    candidates of the horizon waypoint's distance to it plus a weighted
    implied-speed mismatch. Without it: the model's best reference line
    and its speed-closest mode. Ties go to the first index, as jnp's
    argmin and argmax."""
    bs, R, M = prob.shape
    cand_speed = _candidate_speeds(trajectory)
    if teacher_pos is not None:
        step = min(TEACHER_HORIZON_STEP, trajectory.shape[-2] - 1)
        pose_d = torch.linalg.norm(trajectory[..., step, :2] - teacher_pos[:, None, None], dim=-1)
        score = pose_d + TEACHER_SPEED_WEIGHT * torch.abs(cand_speed - teacher_speed[:, None, None])
        score = torch.where(r_pad[:, :, None], torch.inf, score)
        return torch.argmin(score.reshape(bs, -1), dim=-1)
    masked = torch.where(r_pad[:, :, None], -1e8, prob).reshape(bs, -1)
    best_r = torch.argmax(masked, dim=-1) // M
    speed_at_r = cand_speed[torch.arange(bs, device=prob.device), best_r]  # [bs, M]
    m_idx = torch.argmin(torch.abs(speed_at_r - teacher_speed[:, None]), dim=-1)
    return best_r * M + m_idx


class ReinforcePlutoPolicy(_FineTunedPluto):
    """'reinforce_pluto': the executed candidate's log-prob times the
    gamma=0.98-discounted return of the executed transitions' dense
    rewards (chunk-truncated with a critic bootstrap)."""

    name = "reinforce_pluto"
    type = "rlft"
    RETURN_KEY = "ret"

    def _loss_fn(self, model, batch):
        out, r_pad = self._forward(model, batch)
        return reinforce_loss(out["probability"], r_pad, batch["chosen_idx"],
                              batch[self.RETURN_KEY])


class RSPlutoPolicy(ReinforcePlutoPolicy):
    """'rs_pluto': REINFORCE on the shaped return, env reward + 0.2 x
    (-|teacher target speed - executed desired speed|)."""

    name = "rs_pluto"
    RETURN_KEY = "ret_shaped"


class SFTPlutoPolicy(_FineTunedPluto):
    """'sft_pluto': cross-entropy to the privileged teacher's candidate."""

    name = "sft_pluto"
    type = "sft"

    def _loss_fn(self, model, batch):
        out, r_pad = self._forward(model, batch)
        prob = out["probability"]
        teacher = _teacher_label(prob, r_pad, out["trajectory"], batch["teacher_speed"],
                                 batch.get("teacher_pos"))
        return sft_loss(prob, r_pad, teacher, batch["valid"].reshape(prob.shape[0], -1).any(-1))


class BCPlutoPolicy(_FineTunedPluto):
    """'bc_pluto': behaviour-cloning pretrain of the whole model toward the
    privileged lane-follow teacher (winner-takes-all regression of the
    closest candidate, cross-entropy toward it, and the ref-free head's
    regression), on expert rollouts: the CBVs execute the teacher's path.
    Every layer trains, at lr 1e-3, clip 5.0, no closed-loop decay, unless
    the config names its own `train`. Its result (`save_pretrain`) seeds
    the fine-tune zoo (`load_pretrain`)."""

    name = "bc_pluto"
    type = "il"
    execute_teacher = True

    def __init__(self, tmap, cfg=None, **kw):
        super().__init__(tmap, cfg, **kw)
        if not (cfg or {}).get("train"):
            self.train_cfg = dataclasses.replace(
                self.train_cfg, trainable_prefixes=(), cl_lr_decay=1.0, lr=1e-3,
                grad_clip=5.0,
            )

    def _loss_fn(self, model, batch):
        out, r_pad = self._forward(model, batch)
        bs = out["probability"].shape[0]
        cand = out["trajectory"][..., :2]  # [bs, R, M, F, 2]
        tt = batch["teacher_traj"]  # [bs, F, 2]
        ade = torch.linalg.norm(cand - tt[:, None, None], dim=-1).mean(-1)
        flat_ade = torch.where(r_pad[:, :, None], torch.inf, ade).reshape(bs, -1)
        target = torch.argmin(flat_ade, dim=-1)
        wta = flat_ade.gather(1, target[:, None])[:, 0]
        w = (batch["valid"].reshape(bs, -1).any(-1) & torch.isfinite(wta)).float()
        n = torch.clamp(w.sum(), min=1.0)
        reg = torch.sum(torch.where(w > 0, wta, 0.0)) / n
        ce = sft_loss(out["probability"], r_pad, target, w > 0)
        rf = out["output_ref_free_trajectory"][..., :2]
        rf_reg = torch.sum(torch.linalg.norm(rf - tt, dim=-1).mean(-1) * w) / n
        return reg + ce + 0.5 * rf_reg


class RTRPlutoPolicy(_FineTunedPluto):
    """'rtr_pluto': PPO clip on the executed candidate (GAE advantage)
    plus the teacher cross-entropy."""

    name = "rtr_pluto"
    type = "sft"
    lambda_rl = 5.0

    def _ppo_term(self, prob, r_pad, batch):
        chosen = batch["chosen_idx"].long()[:, None]
        adv = batch["gae"].detach()
        w = batch["gae_valid"].float()
        old_lp = masked_log_softmax(batch["old_logits"], r_pad).gather(1, chosen)[:, 0]
        lp = masked_log_softmax(prob, r_pad)
        cur_lp = lp.gather(1, chosen)[:, 0]
        ratio = torch.exp(cur_lp - old_lp.detach())
        obj = torch.minimum(adv * ratio, adv * torch.clamp(ratio, 0.8, 1.2))
        n = torch.clamp(w.sum(), min=1.0)
        surrogate = torch.sum(obj * w) / n
        entropy = -torch.sum(torch.exp(lp) * torch.clamp(lp, min=-1e6), dim=-1).mean()
        return surrogate, entropy

    def _loss_fn(self, model, batch):
        out, r_pad = self._forward(model, batch)
        prob = out["probability"]
        surrogate, _ = self._ppo_term(prob, r_pad, batch)
        teacher = _teacher_label(prob, r_pad, out["trajectory"], batch["teacher_speed"],
                                 batch.get("teacher_pos"))
        teacher_ce = sft_loss(prob, r_pad, teacher,
                              batch["valid"].reshape(prob.shape[0], -1).any(-1))
        return -self.lambda_rl * surrogate + teacher_ce


class PPOPlutoPolicy(RTRPlutoPolicy):
    """'ppo_pluto': actor-critic PPO, the clipped surrogate on the executed
    candidate with a GAE(lambda) advantage, an entropy bonus and a
    SmoothL1 value loss on the critic head, which trains beside pi_head."""

    name = "ppo_pluto"
    type = "rlft"
    lambda_rl = 1.0
    VALUE_COEF = 0.5
    value_head = True

    def __init__(self, tmap, cfg=None, **kw):
        super().__init__(tmap, cfg, **kw)
        prefixes = tuple(self.train_cfg.trainable_prefixes)
        if "value_head" not in prefixes:
            self.train_cfg = dataclasses.replace(
                self.train_cfg, trainable_prefixes=prefixes + ("value_head",)
            )

    def _loss_fn(self, model, batch):
        out, r_pad = self._forward(model, batch)
        surrogate, entropy = self._ppo_term(out["probability"], r_pad, batch)
        # the critic's target: GAE + V_old, the lambda-return
        target = (batch["gae"] + batch["value"]).detach()
        w = batch["gae_valid"].float()
        n = torch.clamp(w.sum(), min=1.0)
        v_loss = torch.sum(smooth_l1(out["value"], target) * w) / n
        return -(surrogate + 0.01 * entropy) + self.VALUE_COEF * v_loss


class ClassicCBVPolicy:
    """'ppo': MLP PPO on the 3-agent relative-state observation, driving
    (acc, steer) as raw controls (the reference's cbv/planning/rl/ppo.py).
    Weights from the config's `seed` (0 by default); sampling noise from a
    generator on the map's device seeded the same way."""

    name = "ppo"
    type = "rl"
    trainable = True

    def __init__(self, tmap, cfg=None):
        cfg = cfg or {}
        self.tmap = tmap
        self.max_cbvs = cfg.get("max_cbvs", 3)
        self.ppo = ClassicPPO(seed=cfg.get("seed", 0), device=tmap.device)
        self.gen = torch.Generator(tmap.device).manual_seed(cfg.get("seed", 0))

    def act(self, spec, state, train=False):
        """Raw controls `ctrl` [S, A, 3] where `mask` [S, A] holds (the CBV
        slots; never the ego), and per slot [S, C] the observation, sampled
        (train) or mean action, its log-prob, the critic's value and
        `cbv_slots`."""
        S, A = state.alive.shape
        slots = cbv_slot_assignment(state.is_cbv, self.max_cbvs)
        valid = slots >= 0
        slot = torch.clamp(slots, min=0)  # an invalid slot reads agent 0
        obs = cbv_normal_obs(state, slot)
        flat_obs = obs.reshape((-1,) + obs.shape[2:])
        action, logp = self.ppo.act(flat_obs, self.gen, deterministic=not train)
        ctrl_sc = rl_action_to_control(action).reshape(S, -1, 3)
        # scatter to the CBV slots; an invalid slot writes agent 0's old
        # value back (slot 0 is the ego, never a CBV)
        scen = torch.arange(S, device=slots.device)[:, None]
        ctrl = torch.zeros((S, A, 3), device=obs.device)
        ctrl[scen, slot] = torch.where(valid[..., None], ctrl_sc, ctrl[scen, slot])
        mask = torch.zeros((S, A), dtype=torch.bool, device=obs.device)
        mask[scen, slot] = valid | mask[scen, slot]
        mask[:, 0] = False
        return {"ctrl": ctrl, "mask": mask, "obs": obs, "logp": logp.reshape(slots.shape),
                "action": action.reshape(slots.shape + (2,)),
                "value": self.ppo.value(flat_obs).reshape(slots.shape), "cbv_slots": slots}

    def train_round(self, batch):
        return self.ppo.train(batch)

    def save(self, mgr, episode):
        mgr.save(self.ppo.state_dict(), episode, name=f"cbv_{self.name}")


class FREAPolicy(ClassicCBVPolicy):
    """'frea': in the reference, pretrained FREA weights, load only. With
    `cfg['weights']`, a checkpoint directory of the port's (a
    `cbv_<name>-episode_N` file, the latest, as `save` writes it) is
    loaded; without, the same PPO net runs from fresh weights, with a
    warning. (The JAX package's orbax checkpoints are not read.)"""

    name = "frea"

    def __init__(self, tmap, cfg=None):
        super().__init__(tmap, cfg)
        path = (cfg or {}).get("weights", "")
        if path:
            self.load_weights(path)
        else:
            warnings.warn(
                f"{self.name}: reference behavior is load-only pretrained "
                "weights (rl/frea.py); none provided via cfg['weights'] — "
                "running an untrained PPO net instead.",
                stacklevel=2,
            )

    def load_weights(self, path):
        state_dict, _ = CheckpointManager(path).restore(name=f"cbv_{self.name}",
                                                        map_location=self.tmap.device)
        if state_dict is not None:
            self.ppo.load_state_dict(state_dict)


class FPPORsPolicy(FREAPolicy):
    """'fppo_rs': FREA's load-only contract."""

    name = "fppo_rs"


CBV_POLICY_LIST: dict[str, Callable] = _Registry("CBV", {
    "standard": DummyPolicy,
    "ppo": ClassicCBVPolicy,
    "frea": FREAPolicy,
    "fppo_rs": FPPORsPolicy,
    "pluto": PlutoPolicy,
    "bc_pluto": BCPlutoPolicy,
    "sft_pluto": SFTPlutoPolicy,
    "rtr_pluto": RTRPlutoPolicy,
    "rs_pluto": RSPlutoPolicy,
    "reinforce_pluto": ReinforcePlutoPolicy,
    "ppo_pluto": PPOPlutoPolicy,
    "grpo_pluto": GRPOPlutoPolicy,
    "rift_pluto": RIFTPlutoPolicy,
})


# ---------------------------------------------------------------------------
# Ego policies
# ---------------------------------------------------------------------------
class PDMLiteEgo:
    """'pdm_lite': the default privileged rule expert (ego/pdm_ego.py: a
    forecast sweep of every vehicle against the route, IDM to the first
    hazard). In the fused loop `rollout.rollout_chunk` computes its
    waypoints every tick (its kind in run.py's FUSED_EGO_KIND)."""

    name = "pdm_lite"
    type = "unlearnable"

    def __init__(self, tmap, cfg=None):
        self.tmap = tmap

    def act(self, spec, state):
        return pdm_ego_waypoints(spec, state, self.tmap)


class BehaviorEgo(PDMLiteEgo):
    """'behavior': the leader-gap IDM route follower (ego/rule_ego.py), the
    CARLA BehaviorAgent's counterpart. The fused loop leaves it to
    env_step, which gives it the map (lights, junction yields, stop
    signs); its `act`, as the JAX package's, computes it without the map."""

    name = "behavior"

    def act(self, spec, state):
        return rule_ego_waypoints(spec, state)


class ExpertEgo(PDMLiteEgo):
    """'expert': the PDM core plus privileged lane changes (a slow leader
    with a clear adjacent lane is overtaken instead of followed)."""

    name = "expert"

    def act(self, spec, state):
        return pdm_ego_waypoints(spec, state, self.tmap, lane_change=True)


class ExpertDisturbEgo(ExpertEgo):
    """'expert_disturb': the expert's waypoints plus Gaussian noise of std
    `noise_std` (cfg, 0.3), one draw a tick from a generator on the map's
    device seeded with `seed` (0: the JAX CLI never passes one)."""

    name = "expert_disturb"

    def __init__(self, tmap, cfg=None, noise_std=0.3, seed=0):
        super().__init__(tmap, cfg)
        self.noise_std = (cfg or {}).get("noise_std", noise_std)
        self.gen = torch.Generator(tmap.device).manual_seed(seed)

    def act(self, spec, state):
        wp = super().act(spec, state)
        return wp + self.noise_std * torch.randn(wp.shape, generator=self.gen, device=wp.device)


class PlanTEgo:
    """'plant': the learned object-token transformer ego (models/plant;
    PlanT_medium by default: dim 512, 8 layers, 8 heads). Its weights are
    made at first use from a CPU `torch.Generator` seeded from the
    config's `seed` (the same weights on every device), or loaded from a
    PlanT npz (`load`). `rollout.rollout_chunk` computes its waypoints every
    tick (ego kind "plant")."""

    name = "plant"
    type = "il"

    def __init__(self, tmap, cfg=None, seed=0):
        cfg = cfg or {}
        self.tmap = tmap
        self.dims = {k: cfg.get(k, d) for k, d in
                     (("dim", 512), ("num_layers", 8), ("num_heads", 8), ("pred_len", 4))}
        self.seed = cfg.get("seed", seed)
        self.model = None

    def init(self) -> PlanTModel:
        """The model, made on the map's device on the first call."""
        if self.model is None:
            gen = torch.Generator().manual_seed(self.seed)
            model = init_plant_weights(PlanTModel(**self.dims), gen)
            self.model = model.to(self.tmap.device).eval().requires_grad_(False)
        return self.model

    def act(self, spec, state, train=False):
        return plant_ego_waypoints(self.init(), spec, state)

    def load(self, path: str):
        """A trained PlanT npz in the JAX package's format (either package's
        `save_params_npz`), loaded strictly: its dims must be this ego's."""
        load_plant_weights(self.init(), path)


class EgoPPO:
    """'ppo': the MLP PPO ego on the relative-state observation (the
    reference's ego/rl/ppo.py). `act` returns raw controls `ctrl` [S, 3]
    for env_step's `ego_ctrl`, with the observation, action, log-prob and
    value a GAE batch needs. Weights from the config's `seed`; sampling
    noise from a generator on the map's device seeded 0."""

    name = "ppo"
    type = "rl"
    trainable = True
    ROUTE_AHEAD = 10  # route waypoints ahead of the cursor to steer for

    def __init__(self, tmap, cfg=None):
        self.tmap = tmap
        self.ppo = ClassicPPO(seed=(cfg or {}).get("seed", 0), device=tmap.device)
        self.gen = torch.Generator(tmap.device).manual_seed(0)

    def act(self, spec, state, train=False):
        cursor = torch.minimum(state.ego_route_cursor.to(torch.int32) + self.ROUTE_AHEAD,
                               spec.ego_route_len - 1).long()
        next_wp = spec.ego_route[torch.arange(cursor.shape[0], device=cursor.device),
                                 cursor, :2]
        obs = ego_normal_obs(state, next_wp)
        action, logp = self.ppo.act(obs, self.gen, deterministic=not train)
        return {"ctrl": rl_action_to_control(action), "obs": obs, "action": action,
                "logp": logp, "value": self.ppo.value(obs)}

    def train_round(self, batch):
        return self.ppo.train(batch)

    def save(self, mgr, episode):
        mgr.save(self.ppo.state_dict(), episode, name="ego_ppo")


class E2EEgo:
    """'vad' / 'uniad' / 'sparsedrive': the E2E camera stacks
    (models/e2e) on the semantic camera rig (ego/sensors.py). Weights come
    from an npz in the JAX package's format (`cfg['weights']`, or
    `--ego_weights` through `load`), loaded strictly; without one they are
    made at first use from a CPU `torch.Generator` seeded from the config's
    `seed` (the same weights on every device). `train_bc` bootstraps them
    by cloning the PDM expert closed-loop (models/e2e/train.py); it fits a
    fresh model of the default width, whatever the config's `dim` and
    `num_heads`, and seed 0, as the JAX package's does (ROADMAP.md §3).
    `rollout.rollout_chunk` computes its waypoints every tick (ego kind
    "e2e")."""

    type = "il"

    def __init__(self, tmap, cfg=None, seed=0):
        cfg = cfg or {}
        self.tmap = tmap
        self.dims = {"dim": cfg.get("dim", 64), "num_heads": cfg.get("num_heads", 4)}
        self.seed = cfg.get("seed", seed)
        self.model = None
        if cfg.get("weights"):
            self.load(cfg["weights"])

    def init(self) -> E2EModel:
        """The model, made on the map's device on the first call."""
        if self.model is None:
            model = init_e2e_weights(E2EModel(self.name, **self.dims),
                                     torch.Generator().manual_seed(self.seed))
            self.model = model.to(self.tmap.device).eval().requires_grad_(False)
        return self.model

    def act(self, spec, state, train=False):
        return e2e_ego_waypoints(self.init(), self.tmap, spec, state)

    def train_bc(self, spec, state, crit, **kw):
        model, losses = bc_train(self.name, self.tmap, spec, state, crit, **kw)
        self.model = model.eval().requires_grad_(False)
        return losses

    def load(self, path: str):
        load_jax_params(self.init(), flatten_params(load_params_npz(path)))

    def save(self, path: str):
        save_params_npz(self.init(), path)


class VADEgo(E2EEgo):
    name = "vad"


class UniADEgo(E2EEgo):
    name = "uniad"


class SparseDriveEgo(E2EEgo):
    name = "sparsedrive"


EGO_POLICY_LIST: dict[str, Callable] = _Registry("ego", {
    "pdm_lite": PDMLiteEgo,
    "behavior": BehaviorEgo,
    "expert": ExpertEgo,
    "expert_disturb": ExpertDisturbEgo,
    "plant": PlanTEgo,
    "ppo": EgoPPO,
    "vad": VADEgo,
    "uniad": UniADEgo,
    "sparsedrive": SparseDriveEgo,
})
