"""The classic RL stack (port of rift_tpu/rl/classic.py): relative-state
observations, the (acc, steer) action conversion, the full-train CBV
reward and the ego's shaped reward, and MLP actor-critic PPO.

The JAX package vmaps its observations over scenarios and CBV slots; here
they are batched: `cbv_normal_obs` over [S, C] slots, `ego_normal_obs`
over [S]. The actor and critic are `nn.Module`s under flax's names
(`Dense_0..2`, `log_std`), so a JAX `ClassicPPO.params` loads into them
(utils/params_io.py:load_ppo_params); fresh weights come from flax's
initialisers drawn from a CPU `torch.Generator` (the same weights on every
device). The JAX package's random draws (initial weights, sampling noise)
are not reproduced, only their distributions.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..geometry.se2 import wrap_angle
from ..sim.state import SimState
from .losses import gae

OBS_AGENTS = 3  # rows: self, ego, nearest other (reference max_agent)
OBS_DIM = 6  # [x, y, bbox_x, bbox_y, yaw, forward speed]
ACC_MAX, STEER_MAX = 3.0, 0.3  # action scaling (gym_carla action config)
GOAL_RADIUS = 3.0


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------
def _gather(x, idx):
    """x [S, A, ...] at agent indices idx [S, ...] -> [S, ..., ...]."""
    S = x.shape[0]
    scen = torch.arange(S, device=x.device).reshape((S,) + (1,) * (idx.dim() - 1))
    return x[scen, idx]


def _to_frame(rel, heading):
    """(..., 2) world offsets into the frame of `heading` (...,)."""
    c, s = torch.cos(-heading), torch.sin(-heading)
    return torch.stack([rel[..., 0] * c - rel[..., 1] * s,
                        rel[..., 0] * s + rel[..., 1] * c], dim=-1)


def _relative_rows(state: SimState, center, others):
    """[..., K, OBS_DIM] rows of [x, y, half_len, half_wid, rel_yaw, speed]
    of agents `others` [S, ..., K] in the frame of agent `center` [S, ...]."""
    cp = _gather(state.pos, center)[..., None, :]
    ch = _gather(state.heading, center)[..., None]
    xy = _to_frame(_gather(state.pos, others) - cp, ch)
    shape = _gather(state.shape, others)
    return torch.cat([
        xy, shape[..., 1:2] * 0.5, shape[..., 0:1] * 0.5,
        wrap_angle(_gather(state.heading, others) - ch)[..., None],
        _gather(state.speed, others)[..., None],
    ], dim=-1)


def cbv_normal_obs(state: SimState, slots: torch.Tensor) -> torch.Tensor:
    """[S, C, OBS_AGENTS + 1, OBS_DIM] of each CBV slot `slots` [S, C] (agent
    indices, >= 0): self, ego, nearest other alive agent, goal row. With no
    other agent alive the nearest is agent 0 (argmin over all-inf) and its
    row is zeroed."""
    S, A = state.alive.shape
    ar = torch.arange(A, device=slots.device)
    pos_c = _gather(state.pos, slots)  # [S, C, 2]
    d = torch.linalg.norm(state.pos[:, None] - pos_c[:, :, None], dim=-1)  # [S, C, A]
    others = state.alive[:, None] & (ar != slots[..., None]) & (ar != 0)
    d = torch.where(others, d, torch.inf)
    nearest = torch.argmin(d, dim=-1)  # the first of equal distances
    rows = _relative_rows(state, slots, torch.stack([slots, torch.zeros_like(slots), nearest],
                                                     dim=-1))
    seen = torch.isfinite(d.gather(-1, nearest[..., None]))[..., 0]
    rows = torch.cat([rows[..., :2, :], rows[..., 2:, :] * seen[..., None, None].float()], dim=-2)
    # goal row: [x, y, r, r, rel_yaw (0), distance]
    rel = _gather(state.goal, slots) - pos_c
    g = _to_frame(rel, _gather(state.heading, slots))
    r = torch.full_like(g[..., :1], GOAL_RADIUS)
    goal_row = torch.cat([g, r, r, torch.zeros_like(r),
                          torch.linalg.norm(rel, dim=-1)[..., None]], dim=-1)
    return torch.cat([rows, goal_row[..., None, :]], dim=-2)


def ego_normal_obs(state: SimState, route_next_wp: torch.Tensor) -> torch.Tensor:
    """[S, OBS_AGENTS + 1, OBS_DIM]: the ego, its two nearest agents, and
    the row of the route waypoint `route_next_wp` [S, 2]. The nearest two
    are the JAX package's `top_k(-d, 2)`: ties and dead agents (inf) go to
    the lowest indices first, and a dead agent picked so keeps its row."""
    S, A = state.alive.shape
    ar = torch.arange(A, device=state.pos.device)
    d = torch.linalg.norm(state.pos - state.pos[:, :1], dim=-1)
    d = torch.where(state.alive & (ar != 0), d, torch.inf)
    idx = torch.sort(d, dim=-1, stable=True).indices[:, :min(2, A)]
    zero = torch.zeros((S, 1), dtype=idx.dtype, device=idx.device)
    rows = _relative_rows(state, zero[:, 0], torch.cat([zero, idx], dim=-1))
    rel = route_next_wp - state.pos[:, 0]
    xy = _to_frame(rel, state.heading[:, 0])
    z = torch.zeros_like(xy[..., :1])
    route_row = torch.cat([xy, z, z, z, torch.linalg.norm(rel, dim=-1)[..., None]], dim=-1)
    return torch.cat([rows, route_row[:, None]], dim=1)


# ---------------------------------------------------------------------------
# Action conversion (acc, steer) in [-1, 1]^2 -> throttle/steer/brake
# ---------------------------------------------------------------------------
def rl_action_to_control(action: torch.Tensor) -> torch.Tensor:
    """(..., 2) normalised (acc, steer) -> (..., 3) throttle/steer/brake:
    throttle = clip(acc / 3), brake = clip(-acc / 8) (no reverse)."""
    acc = torch.clamp(action[..., 0] * ACC_MAX, -ACC_MAX, ACC_MAX)
    steer = torch.clamp(action[..., 1] * STEER_MAX, -STEER_MAX, STEER_MAX)
    throttle = torch.clamp(acc / 3.0, 0.0, 1.0)
    brake = torch.clamp(-acc / 8.0, 0.0, 1.0)
    return torch.stack([throttle, steer, brake], dim=-1)


def control_to_rl_action(control: torch.Tensor) -> torch.Tensor:
    """The inverse, for data collection."""
    throttle, steer, brake = control[..., 0], control[..., 1], control[..., 2]
    acc = torch.where(brake > 0, -brake * 8.0, throttle * 3.0)
    return torch.stack([acc / ACC_MAX, steer / STEER_MAX], dim=-1)


# ---------------------------------------------------------------------------
# Rewards
# ---------------------------------------------------------------------------
def cbv_full_train_reward(goal_dist_prev, goal_dist_now, collided_with_other, reached_goal):
    """Goal progress (clipped to [-1, 1]) - 15 x a collision not involving
    the ego + 15 x reaching the goal."""
    delta = torch.clamp(goal_dist_prev - goal_dist_now, -1.0, 1.0)
    return delta - 15.0 * collided_with_other.float() + 15.0 * reached_goal.float()


def ego_shaped_reward(speed_lon, steer, lane_dist, collided, desired_speed: float = 8.0,
                      out_lane_thres: float = 4.0):
    """The ego's shaped reward (the reference's ego_reward.py)."""
    r_collision = -10.0 * collided.float()
    r_steer = -5.0 * steer**2
    r_out = -1.0 * (torch.abs(lane_dist) > out_lane_thres).float()
    r_fast = -10.0 * (speed_lon > desired_speed).float()
    r_lat = -0.2 * torch.abs(steer) * speed_lon**2
    return r_collision + speed_lon + r_fast + r_out + r_steer + r_lat - 0.1


# ---------------------------------------------------------------------------
# MLP actor-critic
# ---------------------------------------------------------------------------
class _MLP(nn.Module):
    """Dense_0, Dense_1 (tanh), Dense_2 on the flattened [..., rows, 6] obs."""

    def __init__(self, obs_rows: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(obs_rows * OBS_DIM, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, out)

    def trunk(self, obs):
        x = obs.reshape(obs.shape[:-2] + (-1,))
        x = torch.tanh(self.Dense_0(x))
        return self.Dense_2(torch.tanh(self.Dense_1(x)))


class ActorPPO(_MLP):
    """(tanh mean [..., 2], log_std [2]) of the Gaussian policy."""

    def __init__(self, obs_rows: int = OBS_AGENTS + 1, hidden: int = 128,
                 action_dim: int = 2):
        super().__init__(obs_rows, hidden, action_dim)
        self.log_std = nn.Parameter(torch.full((action_dim,), -0.5))

    def forward(self, obs):
        return torch.tanh(self.trunk(obs)), self.log_std


class CriticPPO(_MLP):
    """The state value [...]."""

    def __init__(self, obs_rows: int = OBS_AGENTS + 1, hidden: int = 128):
        super().__init__(obs_rows, hidden, 1)

    def forward(self, obs):
        return self.trunk(obs)[..., 0]


@torch.no_grad()
def init_dense_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """flax's Dense initialisers drawn from `gen`: kernels lecun-normal (a
    normal truncated at 2 std, scaled to variance 1/fan-in), biases 0;
    other parameters keep their constant init."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
            w = torch.empty(mod.in_features, mod.out_features)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            mod.weight.copy_(w.T * std)
            mod.bias.zero_()
    return model


def gaussian_log_prob(mean, log_std, action):
    var = torch.exp(2 * log_std)
    return (-0.5 * torch.sum((action - mean) ** 2 / var, dim=-1) - torch.sum(log_std)
            - 0.5 * action.shape[-1] * math.log(2 * math.pi))


class ClassicPPO:
    """PPO for the MLP policies (gamma 0.98, GAE lambda 0.95, clip 0.2,
    entropy bonus), full-batch Adam steps (optax `adam(lr)`: betas 0.9 and
    0.999, eps 1e-8) on the actor and critic together. Weights from `seed`
    on a CPU generator, then moved to `device`."""

    def __init__(self, obs_rows: int = OBS_AGENTS + 1, lr: float = 3e-4, clip: float = 0.2,
                 gamma: float = 0.98, lam: float = 0.95, entropy_coef: float = 0.01,
                 epochs: int = 10, seed: int = 0, device=None):
        gen = torch.Generator().manual_seed(seed)
        self.actor = init_dense_weights(ActorPPO(obs_rows), gen).to(device)
        self.critic = init_dense_weights(CriticPPO(obs_rows), gen).to(device)
        self.clip, self.gamma, self.lam = clip, gamma, lam
        self.entropy_coef, self.epochs = entropy_coef, epochs
        self.opt = torch.optim.Adam(self.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def parameters(self):
        return [*self.actor.parameters(), *self.critic.parameters()]

    def state_dict(self) -> dict:
        return {"actor": self.actor.state_dict(), "critic": self.critic.state_dict()}

    def load_state_dict(self, state_dict: dict):
        self.actor.load_state_dict(state_dict["actor"])
        self.critic.load_state_dict(state_dict["critic"])

    @torch.no_grad()
    def act(self, obs, gen: torch.Generator | None = None, deterministic: bool = False):
        """(action [..., 2], log-prob [...]): the mean, or a sample from
        `gen` clipped to [-1, 1], its log-prob taken at the clipped action."""
        mean, log_std = self.actor(obs)
        if deterministic:
            return mean, gaussian_log_prob(mean, log_std, mean)
        noise = torch.randn(mean.shape, generator=gen, device=mean.device) * torch.exp(log_std)
        action = torch.clamp(mean + noise, -1.0, 1.0)
        return action, gaussian_log_prob(mean, log_std, action)

    @torch.no_grad()
    def value(self, obs):
        return self.critic(obs)

    def loss(self, batch):
        mean, log_std = self.actor(batch["obs"])
        log_p = gaussian_log_prob(mean, log_std, batch["action"])
        ratio = torch.exp(log_p - batch["old_log_prob"])
        adv = batch["advantage"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)  # jnp's population std
        surrogate = torch.minimum(adv * ratio,
                                  adv * torch.clamp(ratio, 1 - self.clip, 1 + self.clip)).mean()
        entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
        v_loss = torch.mean((self.critic(batch["obs"]) - batch["returns"]) ** 2)
        return -(surrogate + self.entropy_coef * entropy) + 0.5 * v_loss

    def compute_gae(self, rewards, values, dones):
        """Per-trajectory GAE: rewards [T], values [T+1], dones [T]."""
        return gae(rewards, values, dones, self.gamma, self.lam)

    def train(self, batch) -> list[float]:
        """`epochs` Adam steps on the whole batch (obs, action, old_log_prob,
        advantage, returns); each epoch's loss before its step."""
        losses = []
        for _ in range(self.epochs):
            self.opt.zero_grad(set_to_none=True)
            loss = self.loss(batch)
            loss.backward()
            self.opt.step()
            losses.append(loss.detach())
        return [float(x) for x in losses]
