"""Bench2Drive route library: XML parsing, weather, data loaders (port of
rift_tpu/scenario/routes.py, numpy and xml.etree only, copied unchanged).

Covers the reference's route tooling:
  * RouteParser (rift/scenario/tools/route_parser.py:46-198): route XML ->
    configs with keypoints, town, weather; subset selection "1,3-5" syntax.
  * ScenarioDataParser (rift/scenario/scenario_data_parser.py:17-88):
    configs x repetitions clustered by town.
  * Eval/TrainDataLoader (rift/scenario/scenario_data_loader.py:43-401):
    batches of spatially non-overlapping routes, shuffled train sampling,
    resume by completed-route count.

All host-side (episode-rare). Bench2Drive route XMLs parse directly.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Weather:
    """Per-route weather keyframes (route_parser.py parse_weather).

    Keyframes are the raw XML attribute dicts; `route_percentage` keys the
    position along the route the frame applies at. `at(pct)` linearly
    interpolates every numeric attribute between the surrounding keyframes —
    the dynamic-weather semantics CARLA's leaderboard applies as the ego
    progresses (env_wrapper.py:59-73 picks the frame, the agent keeps
    interpolating). Consumers: the BEV renderer (tint/HUD) and the route
    statistics record."""

    keyframes: list[dict] = field(default_factory=list)

    def at(self, pct: float) -> dict:
        """Numeric weather attributes interpolated at `pct` (0-100)."""
        frames = []
        for kf in self.keyframes:
            try:
                p = float(kf.get("route_percentage", 0.0))
            except (TypeError, ValueError):
                p = 0.0
            vals = {}
            for k, v in kf.items():
                if k == "route_percentage":
                    continue
                try:
                    vals[k] = float(v)
                except (TypeError, ValueError):
                    pass
            frames.append((p, vals))
        if not frames:
            return {}
        frames.sort(key=lambda f: f[0])
        pct = float(np.clip(pct, frames[0][0], frames[-1][0]))
        for (p0, v0), (p1, v1) in zip(frames, frames[1:]):
            if p0 <= pct <= p1:
                t = 0.0 if p1 == p0 else (pct - p0) / (p1 - p0)
                keys = set(v0) | set(v1)
                return {
                    k: (1 - t) * v0.get(k, 0.0) + t * v1.get(k, 0.0)
                    for k in keys
                }
        return dict(frames[0][1] if pct <= frames[0][0] else frames[-1][1])

    def visibility(self, pct: float = 0.0) -> float:
        """Sensor visibility factor in [0.2, 1.0] from fog/rain.

        The reference's UE4 cameras physically see less through
        fog_density / precipitation (e2e_agent sensor rig under leaderboard
        weather); the semantic camera bridge applies this as a range cut
        (ego/sensors.py render_cameras clips ground hits to
        MAX_RANGE * visibility)."""
        w = self.at(pct)
        fog = w.get("fog_density", 0.0) / 100.0
        rain = w.get("precipitation", 0.0) / 100.0
        return float(np.clip(1.0 - 0.85 * fog - 0.3 * rain, 0.2, 1.0))


@dataclass
class RouteConfig:
    route_id: str
    town: str
    keypoints: np.ndarray  # [N, 3] x, y, z
    weather: Weather = field(default_factory=Weather)
    repetition: int = 0

    @property
    def name(self) -> str:
        return f"RouteScenario_{self.route_id}"


def _parse_subset(tree, routes_subset: str) -> list[str]:
    all_ids = [r.attrib["id"] for r in tree.iter("route")]
    subset: list[str] = []
    for group in routes_subset.replace(" ", "").split(","):
        if "-" in group:
            start, end = group.split("-")
            if start not in all_ids or end not in all_ids:
                raise ValueError(f"route subset bounds not found: {group}")
            i0, i1 = all_ids.index(start), all_ids.index(end)
            if i1 < i0:
                raise ValueError(f"malformed route subset: {group}")
            subset.extend(all_ids[i0 : i1 + 1])
        else:
            if group not in all_ids:
                raise ValueError(f"route id not found: {group}")
            subset.append(group)
    return sorted(set(subset), key=int)


def parse_routes_file(path: str, routes_subset: str = "") -> list[RouteConfig]:
    tree = ET.parse(path)
    subset = _parse_subset(tree, routes_subset) if routes_subset else None
    configs = []
    for route in tree.iter("route"):
        rid = route.attrib["id"]
        if subset is not None and rid not in subset:
            continue
        pts = []
        for wp in route.iter("position"):
            pts.append(
                [float(wp.attrib["x"]), float(wp.attrib["y"]), float(wp.attrib.get("z", 0.0))]
            )
        weather = Weather()
        for w in route.iter("weather"):
            weather.keyframes.append(dict(w.attrib))
        configs.append(
            RouteConfig(
                route_id=rid,
                town=route.attrib.get("town", ""),
                keypoints=np.asarray(pts, dtype=np.float64),
                weather=weather,
            )
        )
    return configs


def group_by_town(
    configs: list[RouteConfig], repetitions: int = 1
) -> dict[str, list[RouteConfig]]:
    """configs x repetitions, clustered by town, sorted by repetition then
    town (scenario_data_parser.py:17-88)."""
    out: dict[str, list[RouteConfig]] = {}
    for rep in range(repetitions):
        for cfg in configs:
            key = f"{cfg.town}-rep{rep}"
            out.setdefault(key, []).append(
                RouteConfig(
                    route_id=cfg.route_id,
                    town=cfg.town,
                    keypoints=cfg.keypoints,
                    weather=cfg.weather,
                    repetition=rep,
                )
            )
    return out


def _routes_overlap(a: RouteConfig, b: RouteConfig, radius: float) -> bool:
    """cKDTree-equivalent proximity test (scenario_data_loader.py:28-40)."""
    d = np.linalg.norm(
        a.keypoints[None, :, :2] - b.keypoints[:, None, :2], axis=-1
    )
    return bool((d < radius).any())


class EvalDataLoader:
    """Deterministic batches of spatially non-overlapping routes with resume
    (scenario_data_loader.py:43-240)."""

    def __init__(
        self,
        configs: list[RouteConfig],
        num_scenario: int,
        overlap_radius: float = 100.0,
        resume_index: int = 0,
    ):
        self.configs = configs[resume_index:]
        self.done = configs[:resume_index]
        self.num_scenario = num_scenario
        self.overlap_radius = overlap_radius

    def __len__(self):
        return len(self.configs)

    def sampler(self) -> list[RouteConfig]:
        batch: list[RouteConfig] = []
        remaining = []
        for cfg in self.configs:
            if len(batch) < self.num_scenario and all(
                not _routes_overlap(cfg, other, self.overlap_radius)
                for other in batch
            ):
                batch.append(cfg)
            else:
                remaining.append(cfg)
        self.configs = remaining
        self.done.extend(batch)
        return batch


class TrainDataLoader(EvalDataLoader):
    """Shuffled sampling with replacement across epochs
    (scenario_data_loader.py:250-401)."""

    def __init__(self, configs, num_scenario, seed: int = 0, resume_episodes: int = 0, **kw):
        super().__init__(configs, num_scenario, **kw)
        self.all_configs = list(configs)
        self.rng = np.random.default_rng(seed)
        self.episode = resume_episodes

    def sampler(self) -> list[RouteConfig]:
        if len(self.configs) < self.num_scenario:
            self.configs = list(self.all_configs)
            self.rng.shuffle(self.configs)
        self.episode += 1
        return super().sampler()
