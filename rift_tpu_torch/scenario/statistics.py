"""Statistics manager: leaderboard records and their aggregation (port of
rift_tpu/scenario/statistics.py: `RouteRecord`, `GlobalStats` and
`StatisticsManager` with the helpers it calls: records, the global row,
the metric table, the live text, and the results file that a resumed run
reads back).

Per-route records carry score_composed = route completion x infraction
penalty, the CBV behaviour sums and distributions and the ego criticality
distributions; the global row aggregates them into the columns of the
paper's Table 1 (BASELINE.md). Numbers leave the device once per episode.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass, field

import numpy as np

from ..sim.state import ScenarioSpec, SimState
from .criteria import (
    CBV_ACC_EDGES,
    CBV_DELTA_SPEED_EDGES,
    CBV_JERK_EDGES,
    CBV_SPEED_EDGES,
    CBV_TARGET_SPEED_EDGES,
    EGO_METRIC_EDGES,
    EGO_SPEED_EDGES,
    CriteriaState,
    driving_score,
)

CBV_EDGES = {
    "speed": CBV_SPEED_EDGES,
    "delta_speed": CBV_DELTA_SPEED_EDGES,
    "target_speed": CBV_TARGET_SPEED_EDGES,
    "acc": CBV_ACC_EDGES,
    "jerk": CBV_JERK_EDGES,
}


def _hist_labels(edges) -> list[str]:
    """Bin labels in the reference's JSON format ("0~0.5", ...)."""
    e = [float(x) for x in edges]
    return [f"{e[i]:g}~{e[i + 1]:g}" for i in range(len(e) - 1)]


def sample_from_hist(edges, counts, n_samples: int = 3000, seed: int = 0):
    """Uniform-within-bin samples from a histogram."""
    rng = np.random.RandomState(seed)
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0:
        return np.zeros(n_samples)
    idx = rng.choice(len(counts), size=n_samples, p=counts / total)
    return rng.uniform(np.asarray(edges)[idx], np.asarray(edges)[idx + 1])


def shapiro_w(edges, counts) -> float:
    """Shapiro-Wilk W of samples rebuilt from the histogram (the "SW"
    normality similarity); NaN for an empty or degenerate histogram."""
    counts = np.asarray(counts, np.float64)
    if counts.sum() < 3:
        return float("nan")
    from scipy import stats

    samples = sample_from_hist(edges, counts)
    if np.ptp(samples) < 1e-12:
        return float("nan")
    return float(stats.shapiro(samples)[0])


def metric_stats_2d(hist, speed_threshold: float = 3.0):
    """Weighted mean and std of the metric-bin midpoints over the cells
    whose speed-bin lower edge is at least the threshold. hist:
    [n_speed_bins, n_metric_bins]."""
    hist = np.asarray(hist, np.float64)
    rows = np.asarray(EGO_SPEED_EDGES)[:-1] >= speed_threshold
    mids = 0.5 * (np.asarray(EGO_METRIC_EDGES)[:-1] + np.asarray(EGO_METRIC_EDGES)[1:])
    counts = hist[rows].sum(axis=0)
    total = counts.sum()
    if total == 0:
        return float("nan"), float("nan")
    mean = float((counts * mids).sum() / total)
    var = float((counts * mids**2).sum() / total - mean**2)
    return mean, math.sqrt(max(var, 0.0))


@dataclass
class RouteRecord:
    route_id: str
    index: int
    status: str = "Completed"
    weather: dict = field(default_factory=dict)
    driving_score: float = 0.0
    route_completion: float = 0.0
    infraction_penalty: float = 1.0
    collisions_vehicle: int = 0
    collisions_pedestrian: int = 0
    collisions_static: int = 0
    red_light: int = 0
    stop_infraction: int = 0
    blocked: bool = False
    route_deviation: bool = False
    timeout: bool = False
    # ego mean speed as % of the surrounding traffic's (recorded only)
    min_speed_pct: float = 100.0
    route_length_m: float = 0.0
    duration_ticks: int = 0
    ego_progress_m: float = 0.0
    # CBV behaviour (seconds of game time)
    cbv_total_game_time: float = 0.0
    cbv_off_road_game_time: float = 0.0
    cbv_uncomfortable_game_time: float = 0.0
    cbv_progress: float = 0.0
    cbv_collision_count: int = 0
    cbv_count: int = 0
    cbv_reach_goal_count: int = 0
    cbv_mean_speed: float = 0.0
    cbv_mean_abs_acc: float = 0.0
    cbv_mean_abs_jerk: float = 0.0
    # raw moment sums for exact global mean and std (keys speed, acc, jerk,
    # delta_speed, target_speed -> [sum, sum_sq, n])
    sums: dict = field(default_factory=dict)
    # behaviour distributions {metric: {"lo~hi": count}}
    cbv_distributions: dict = field(default_factory=dict)
    # ego criticality distributions {metric: speed x metric bins}
    ego_distributions: dict = field(default_factory=dict)


@dataclass
class GlobalStats:
    """One row of BASELINE.md Table 1 and the aggregates behind it."""

    total_routes: int = 0
    avg_driving_score: float = 0.0
    avg_route_completion: float = 0.0
    avg_infraction_penalty: float = 1.0
    ego_blocked_ratio: float = 0.0  # EBR, %
    off_road_ratio: float = 0.0  # ORR, % of CBV game time off-road
    uncomfortable_pct: float = 0.0  # UC, %
    collisions_per_km: float = 0.0  # CPK (CBV collisions / CBV km)
    route_progress_m: float = 0.0  # RP (total CBV progress, m)
    sw_speed: float = float("nan")  # Shapiro-Wilk W of CBV speed
    wd_speed: float = float("nan")  # Wasserstein distance to the target speed
    sw_acc: float = float("nan")
    rttc_mean: float = float("nan")
    rttc_std: float = float("nan")
    act_mean: float = float("nan")
    act_std: float = float("nan")
    ei_mean: float = float("nan")
    ei_std: float = float("nan")
    ego_collisions_per_km: float = 0.0
    cbv_mean_speed: float = 0.0
    cbv_speed_std: float = 0.0
    cbv_mean_abs_acc: float = 0.0
    cbv_acc_std: float = 0.0
    cbv_mean_abs_jerk: float = 0.0
    cbv_jerk_std: float = 0.0
    cbv_reach_goal_pct: float = 0.0
    min_speed_pct: float = 100.0


def _status(c, s) -> str:
    for flag, name in ((c.route_complete, "Completed"), (c.blocked, "Blocked"),
                       (c.route_deviation, "Deviated"), (c.timeout, "Timeout")):
        if bool(flag[s]):
            return name
    return "Incomplete"


class StatisticsManager:
    def __init__(self, checkpoint_path: str | None = None, resume: bool = False):
        """Records load from `checkpoint_path` only when `resume` is set;
        otherwise a stale results file is overwritten at the first save.
        With a path, every registered episode is saved."""
        self.records: list[RouteRecord] = []
        self.checkpoint_path = checkpoint_path
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            self._load()

    def register_episode(self, crit: CriteriaState, state: SimState, spec: ScenarioSpec,
                         route_ids: list[str] | None = None, dt: float = 0.1,
                         num_valid: int | None = None, weathers: list | None = None):
        """Pull one batch of finished scenarios into records; `num_valid`
        caps how many scenarios become records (a padded last batch).
        `weathers` (a scenario.routes.Weather per scenario) fills each
        record's weather, its keyframes interpolated at the route's
        final completion percentage."""
        ds, rc, penalty = (x.cpu().numpy() for x in driving_score(crit, state, spec))
        # one transfer to the host for everything read below
        c, state, spec = crit.to("cpu"), state.to("cpu"), spec.to("cpu")
        S = ds.shape[0] if num_valid is None else min(num_valid, ds.shape[0])
        for s in range(S):
            n = max(int(c.cbv_count[s]), 1)
            ticks = max(int(c.done_tick[s]) or int(state.tick[s]), 1)
            moments = lambda key: [
                float(getattr(c, f"cbv_{key}_sum")[s]), float(getattr(c, f"cbv_{key}_sq")[s]), n
            ]
            bg = float(c.min_speed_bg_sum[s])
            self.records.append(RouteRecord(
                route_id=route_ids[s] if route_ids else f"route_{len(self.records)}",
                index=len(self.records),
                status=_status(c, s),
                weather=(
                    weathers[s].at(float(rc[s]))
                    if weathers is not None and s < len(weathers) else {}
                ),
                driving_score=float(ds[s]),
                route_completion=float(rc[s]),
                infraction_penalty=float(penalty[s]),
                collisions_vehicle=int(c.collisions_vehicle[s]),
                collisions_pedestrian=int(c.collisions_pedestrian[s]),
                collisions_static=int(c.collisions_static[s]),
                red_light=int(c.red_light_infractions[s]),
                stop_infraction=int(c.stop_infractions[s]),
                blocked=bool(c.blocked[s]),
                route_deviation=bool(c.route_deviation[s]),
                timeout=bool(c.timeout[s]),
                min_speed_pct=(
                    min(100.0 * float(c.min_speed_ego_sum[s]) / max(bg, 1e-6), 100.0)
                    if int(c.min_speed_points[s]) > 0 else 100.0
                ),
                route_length_m=float(spec.ego_route_len[s]),
                duration_ticks=ticks,
                ego_progress_m=float(state.ego_route_cursor[s]),
                cbv_total_game_time=int(c.cbv_count[s]) * dt,
                cbv_off_road_game_time=int(c.cbv_offroad_ticks[s]) * dt,
                cbv_uncomfortable_game_time=int(c.cbv_uncomfortable_ticks[s]) * dt,
                cbv_progress=float(c.cbv_progress_m[s]),
                cbv_collision_count=int(c.cbv_collisions[s]),
                cbv_count=int(c.cbv_new_count[s]),
                cbv_reach_goal_count=int(c.cbv_reach_goal[s]),
                cbv_mean_speed=float(c.cbv_speed_sum[s]) / n,
                cbv_mean_abs_acc=float(c.cbv_acc_sum[s]) / n,
                cbv_mean_abs_jerk=float(c.cbv_jerk_sum[s]) / n,
                sums={key: moments(key) for key in CBV_EDGES},
                cbv_distributions={
                    key: dict(zip(_hist_labels(edges), getattr(c, f"cbv_{key}_hist")[s].tolist()))
                    for key, edges in CBV_EDGES.items()
                },
                ego_distributions={
                    key: getattr(c, f"ego_{key.lower()}_hist")[s].tolist()
                    for key in ("RTTC", "ACT", "EI")
                },
            ))
        if self.checkpoint_path:
            self.save()

    def _merged_cbv_hist(self, key: str) -> np.ndarray:
        labels = _hist_labels(CBV_EDGES[key])
        return np.array(
            [sum(int(r.cbv_distributions.get(key, {}).get(lb, 0)) for r in self.records)
             for lb in labels], np.int64,
        )

    def _merged_ego_hist(self, key: str) -> np.ndarray:
        out = np.zeros((len(EGO_SPEED_EDGES) - 1, len(EGO_METRIC_EDGES) - 1), np.int64)
        for r in self.records:
            if key in r.ego_distributions:
                out += np.asarray(r.ego_distributions[key], np.int64)
        return out

    def _moments(self, key: str):
        tot = tot_sq = 0.0
        n = 0
        for r in self.records:
            if r.sums.get(key):
                tot, tot_sq, n = tot + r.sums[key][0], tot_sq + r.sums[key][1], n + r.sums[key][2]
        if n == 0:
            return 0.0, 0.0
        mean = tot / n
        return mean, math.sqrt(max(tot_sq / n - mean**2, 0.0))

    def compute_global_statistics(self) -> GlobalStats:
        if not self.records:
            return GlobalStats()
        r = self.records
        n = len(r)
        cbv_time = sum(x.cbv_total_game_time for x in r)
        cbv_km = sum(x.cbv_progress for x in r) / 1000.0
        ego_km = sum(x.route_length_m / 1000.0 * x.route_completion / 100.0 for x in r)
        speed_mean, speed_std = self._moments("speed")
        acc_mean, acc_std = self._moments("acc")
        jerk_mean, jerk_std = self._moments("jerk")
        tgt_mean, tgt_std = self._moments("target_speed")
        rttc_mean, rttc_std = metric_stats_2d(self._merged_ego_hist("RTTC"))
        act_mean, act_std = metric_stats_2d(self._merged_ego_hist("ACT"))
        ei_mean, ei_std = metric_stats_2d(self._merged_ego_hist("EI"))
        return GlobalStats(
            total_routes=n,
            avg_driving_score=float(np.mean([x.driving_score for x in r])),
            avg_route_completion=float(np.mean([x.route_completion for x in r])),
            avg_infraction_penalty=float(np.mean([x.infraction_penalty for x in r])),
            ego_blocked_ratio=100.0 * sum(x.blocked for x in r) / n,
            off_road_ratio=100.0 * sum(x.cbv_off_road_game_time for x in r) / max(cbv_time, 1e-6),
            uncomfortable_pct=100.0
            * sum(x.cbv_uncomfortable_game_time for x in r) / max(cbv_time, 1e-6),
            collisions_per_km=sum(x.cbv_collision_count for x in r) / max(cbv_km, 1e-6),
            route_progress_m=float(sum(x.cbv_progress for x in r)),
            sw_speed=shapiro_w(CBV_SPEED_EDGES, self._merged_cbv_hist("speed")),
            # Gaussian closed form of the Wasserstein distance to the
            # target-speed distribution
            wd_speed=math.sqrt((speed_mean - tgt_mean) ** 2 + (speed_std - tgt_std) ** 2),
            sw_acc=shapiro_w(CBV_ACC_EDGES, self._merged_cbv_hist("acc")),
            rttc_mean=rttc_mean, rttc_std=rttc_std,
            act_mean=act_mean, act_std=act_std,
            ei_mean=ei_mean, ei_std=ei_std,
            ego_collisions_per_km=sum(x.collisions_vehicle for x in r) / max(ego_km, 1e-6),
            cbv_mean_speed=speed_mean, cbv_speed_std=speed_std,
            cbv_mean_abs_acc=acc_mean, cbv_acc_std=acc_std,
            cbv_mean_abs_jerk=jerk_mean, cbv_jerk_std=jerk_std,
            cbv_reach_goal_pct=100.0
            * sum(x.cbv_reach_goal_count for x in r) / max(sum(x.cbv_count for x in r), 1),
            min_speed_pct=float(np.mean([x.min_speed_pct for x in r])),
        )

    def compute_metric_table(self) -> dict:
        """The BASELINE.md Table-1 row of this run (one seed)."""
        g = self.compute_global_statistics()
        return {
            "Driving Score": g.avg_driving_score,
            "Route Completion": g.avg_route_completion,
            "Infraction Penalty": g.avg_infraction_penalty,
            "Ego Blocked Ratio": g.ego_blocked_ratio,
            "ORR": g.off_road_ratio,
            "UC (%)": g.uncomfortable_pct,
            "CPK": g.collisions_per_km,
            "RP": g.route_progress_m,
            "SW speed": g.sw_speed,
            "WD speed": g.wd_speed,
            "SW acc": g.sw_acc,
            "RTTC": (g.rttc_mean, g.rttc_std),
            "ACT": (g.act_mean, g.act_std),
        }

    def live_results_text(self) -> str:
        """Human-readable progress: a per-route table and running
        averages."""
        lines = [
            f"{'idx':>4} {'route':<18} {'status':<12} {'DS':>6} {'RC%':>6} "
            f"{'pen':>5}  infractions",
        ]
        for r in self.records:
            inf = [f"{name} x{n}" for name, n in (
                ("veh", r.collisions_vehicle), ("ped", r.collisions_pedestrian),
                ("static", r.collisions_static), ("red", r.red_light),
                ("stop", r.stop_infraction),
            ) if n]
            inf += [name for name, flag in (
                ("blocked", r.blocked), ("deviation", r.route_deviation), ("timeout", r.timeout),
            ) if flag]
            lines.append(
                f"{r.index:>4} {r.route_id:<18.18} {r.status:<12.12} "
                f"{r.driving_score:>6.1f} {r.route_completion:>6.1f} "
                f"{r.infraction_penalty:>5.2f}  {', '.join(inf) or '-'}"
            )
        if self.records:
            n = len(self.records)
            avg_ds = sum(r.driving_score for r in self.records) / n
            avg_rc = sum(r.route_completion for r in self.records) / n
            lines.append("-" * 64)
            lines.append(f"routes {n}  avg DS {avg_ds:.2f}  avg RC {avg_rc:.2f}")
        return "\n".join(lines) + "\n"

    def save(self, path: str | None = None):
        """The records and the global row as JSON (the JAX package's
        simulation_results.json layout)."""
        path = path or self.checkpoint_path
        if not path:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "progress": [len(self.records), len(self.records)],
            "records": [asdict(x) for x in self.records],
            "global": asdict(self.compute_global_statistics()),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)

    def _load(self):
        with open(self.checkpoint_path) as f:
            payload = json.load(f)
        self.records = [RouteRecord(**x) for x in payload.get("records", [])]

    @property
    def resume_index(self) -> int:
        return len(self.records)
