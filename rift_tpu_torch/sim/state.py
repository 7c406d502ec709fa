"""SimState: the fixed-shape world state (port of rift_tpu/sim/state.py).

Per-actor registries become dense [S, A] tensors with masks. Agent slot 0
of every scenario is the ego; background vehicles occupy the remaining
slots and are promoted to CBVs by flipping `is_cbv`. uint32 fields of the
JAX package (`bv_branch_bits`, `rng`) hold the same values as int64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.tensors import TensorDataclass
from .pid import PID_WINDOW, PIDState, TrackerState

HISTORY_STEPS = 21  # reference: 2 s history @ 10 fps + current frame
DEFAULT_SHAPE = (2.0, 4.9)  # width, length — lincoln.mkz_2017-class sedan

# agent classes (the reference distinguishes collision targets by blueprint:
# vehicle.* / walker.* / static.*, atomic_criteria.py:289-423; penalties
# differ per class, statistics_manager.py:27-44)
CLASS_VEHICLE = 0
CLASS_WALKER = 1
CLASS_STATIC = 2
WALKER_SHAPE = (0.7, 0.7)  # footprint of a pedestrian
STATIC_SHAPE = (1.2, 1.8)  # small layout obstacle (e.g. parked trailer)


@dataclass
class SimState(TensorDataclass):
    # kinematic state
    pos: torch.Tensor  # [S, A, 2] float32 (rear-axle reference point)
    heading: torch.Tensor  # [S, A]
    speed: torch.Tensor  # [S, A] forward speed, m/s
    accel: torch.Tensor  # [S, A] longitudinal accel estimate (m/s^2)
    yaw_rate: torch.Tensor  # [S, A]
    control: torch.Tensor  # [S, A, 3] last applied throttle/steer/brake

    # identity & masks
    alive: torch.Tensor  # [S, A] bool
    is_cbv: torch.Tensor  # [S, A] bool (slot 0 never CBV)
    # inactive background-vehicle pool: spawned along the whole route but
    # physics-off until within BV_ACTIVATE_RADIUS of the ego, then flipped
    # alive once (reference lazy activation, route_scenario.py:157-186)
    bv_pool: torch.Tensor  # [S, A] bool
    shape: torch.Tensor  # [S, A, 2] width, length
    agent_class: torch.Tensor  # [S, A] int32 CLASS_VEHICLE/WALKER/STATIC

    # history ring (index -1 = most recent)
    hist_pos: torch.Tensor  # [S, A, H, 2]
    hist_heading: torch.Tensor  # [S, A, H]
    hist_vel: torch.Tensor  # [S, A, H, 2] world-frame velocity
    hist_valid: torch.Tensor  # [S, A, H] bool

    # map binding
    lane: torch.Tensor  # [S, A] int32 current lane index
    bv_branch_bits: torch.Tensor  # [S, A] uint32 pseudo-random fork choices

    # stop-sign memory (sim/stop_signs.py): zone membership last tick +
    # halt latch (reset on zone entry, persists after exit)
    in_stop_zone: torch.Tensor  # [S, A] bool
    stopped_at_stop: torch.Tensor  # [S, A] bool

    # per-agent goal (CBV route planner), world frame
    goal: torch.Tensor  # [S, A, 2]
    goal_valid: torch.Tensor  # [S, A] bool

    # controllers
    tracker: TrackerState  # batch [S, A]

    # events (this tick)
    collision: torch.Tensor  # [S, A] bool
    collided_with: torch.Tensor  # [S, A] int32 other-agent slot or -1
    offroad: torch.Tensor  # [S, A] bool
    ego_red_entry: torch.Tensor  # [S] bool: ego entered a red-light connector

    # episode bookkeeping
    ego_route_cursor: torch.Tensor  # [S] float32 arclength progressed on route
    tick: torch.Tensor  # [S] int32
    rng: torch.Tensor  # [S, 2] uint32 per-scenario PRNG key

    @property
    def num_scenarios(self) -> int:
        return self.pos.shape[0]

    @property
    def num_agents(self) -> int:
        return self.pos.shape[1]


@dataclass
class ScenarioSpec(TensorDataclass):
    """Episode-static per-scenario data (built at reset on host)."""

    ego_route: torch.Tensor  # [S, RW, 3] x, y, heading (1 m spacing), padded
    ego_route_len: torch.Tensor  # [S] int32 number of valid waypoints
    route_road_ids: torch.Tensor  # [S, RIDS] int32, -1 padded
    route_lane_ids: torch.Tensor  # [S, RIDS] int32
    ego_target_speed: torch.Tensor  # [S] m/s
    timeout_ticks: torch.Tensor  # [S] int32 (reference: 1 s per route meter)
    # lane tables (None allowed for specs that never build planner features)
    route_lane_mask: torch.Tensor | None = None  # [S, L] lane on ego route
    lane_chains: torch.Tensor | None = None  # [S, L, 2, MAX_CHAIN] chains
    # route-distance field (map/routing.py:route_distance_field): driving
    # distance from each lane's start to the ego route + route arclength at
    # the join — replaces the reference's per-candidate A* in recognition
    lane_route_dist: torch.Tensor | None = None  # [S, L] float32 (inf -> 1e9)
    lane_route_join: torch.Tensor | None = None  # [S, L] float32
    # per-scenario sensor visibility factor from route weather (fog/rain),
    # consumed by ego/sensors.py render_cameras; None -> clear weather
    visibility: torch.Tensor | None = None  # [S] float32 in [0.2, 1]


def init_sim_state(num_scenarios: int, num_agents: int, rng=None, device=None) -> SimState:
    """The initial state, built on the host and moved in one pass to the
    device that `resolve_device(device)` gives (CUDA unless asked)."""
    return init_sim_state_host(num_scenarios, num_agents, rng).to(resolve_device(device))


def init_sim_state_host(
    num_scenarios: int,
    num_agents: int,
    rng=None,
) -> SimState:
    """Build the initial state host-side (numpy), mutable for spawn logic;
    `.to(device)` then moves it in one pass."""
    S, A = num_scenarios, num_agents
    if rng is None:
        rng = np.zeros((S, 2), np.uint32)

    def pid():
        return PIDState(
            buf=np.zeros((S, A, PID_WINDOW), np.float32),
            ptr=np.zeros((S, A), np.int32),
            count=np.zeros((S, A), np.int32),
        )

    host_state = SimState(
        pos=np.zeros((S, A, 2), np.float32),
        heading=np.zeros((S, A), np.float32),
        speed=np.zeros((S, A), np.float32),
        accel=np.zeros((S, A), np.float32),
        yaw_rate=np.zeros((S, A), np.float32),
        control=np.zeros((S, A, 3), np.float32),
        alive=np.zeros((S, A), bool),
        is_cbv=np.zeros((S, A), bool),
        bv_pool=np.zeros((S, A), bool),
        shape=np.broadcast_to(
            np.asarray(DEFAULT_SHAPE, np.float32), (S, A, 2)
        ).copy(),
        agent_class=np.zeros((S, A), np.int32),
        hist_pos=np.zeros((S, A, HISTORY_STEPS, 2), np.float32),
        hist_heading=np.zeros((S, A, HISTORY_STEPS), np.float32),
        hist_vel=np.zeros((S, A, HISTORY_STEPS, 2), np.float32),
        hist_valid=np.zeros((S, A, HISTORY_STEPS), bool),
        lane=np.zeros((S, A), np.int32),
        bv_branch_bits=np.zeros((S, A), np.uint32),
        in_stop_zone=np.zeros((S, A), bool),
        stopped_at_stop=np.zeros((S, A), bool),
        goal=np.zeros((S, A, 2), np.float32),
        goal_valid=np.zeros((S, A), bool),
        tracker=TrackerState(speed=pid(), turn=pid()),
        collision=np.zeros((S, A), bool),
        collided_with=np.full((S, A), -1, np.int32),
        offroad=np.zeros((S, A), bool),
        ego_red_entry=np.zeros(S, bool),
        ego_route_cursor=np.zeros(S, np.float32),
        tick=np.zeros(S, np.int32),
        rng=np.asarray(rng, np.uint32),
    )
    return host_state
