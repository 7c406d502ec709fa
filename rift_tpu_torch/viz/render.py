"""BEV scene rendering and video recording (port of rift_tpu/viz/render.py).

Host-side: a frame copies the fields it draws of one scenario of the
port's SimState (torch tensors, on any device) to host numpy once, and
draws them with matplotlib as the JAX package does: the lanes within
1.5 view radii of the ego, the route, dashed reference lines, candidate
trajectories, the agents' oriented boxes with heading ticks, the weather's
dimming and the HUD title. Output: mp4 through cv2 (the reference's mp4
writer), GIF through Pillow where cv2 is absent, and the last frame as a
PNG.

matplotlib, Pillow and cv2 are imported inside the functions that draw or
write, never at import: the package imports without them. A renderer or
recorder made without matplotlib or Pillow raises an ImportError that
names the package; drawing is never skipped.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry.obb import box_corners
from ..map.tensor_map import TensorMap
from ..utils.tensors import to_numpy

EGO_COLOR = "#2ca02c"
CBV_COLOR = "#d62728"
BV_COLOR = "#1f77b4"
LANE_COLOR = "#cccccc"
EDGE_COLOR = "#999999"
ROUTE_COLOR = "#ff7f0e"
REFLINE_COLOR = "#9467bd"
CANDIDATE_COLOR = "#17becf"
WEATHER_TINT = "#3b4a63"
HUD_KEYS = ("cloudiness", "precipitation", "fog_density", "wetness", "sun_altitude_angle")


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or an ImportError naming it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("rendering (--render) needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("writing frames (--render) needs Pillow (PIL), which is not "
                          "installed") from e
    return Image


class BEVRenderer:
    def __init__(self, tmap: TensorMap, view_radius: float = 80.0, figsize=(8, 8)):
        _pyplot()
        self.tmap = tmap
        self.view_radius = view_radius
        self.figsize = figsize
        self._centerline = to_numpy(tmap.centerline)
        self._left = to_numpy(tmap.left_edge)
        self._right = to_numpy(tmap.right_edge)
        self._valid = to_numpy(tmap.valid)

    def render(
        self,
        state,
        scenario: int = 0,
        route: np.ndarray | None = None,
        candidates: np.ndarray | None = None,  # [K, T, 2] world frame
        reference_lines: np.ndarray | None = None,  # [R, N, 2] + mask via nan
        weather: dict | None = None,  # Weather.at(pct) numeric attributes
        ax=None,
    ):
        """Draw one scenario centred on its ego. Returns the figure."""
        plt = _pyplot()
        from matplotlib.patches import Polygon as MplPolygon

        own_fig = ax is None
        if own_fig:
            fig, ax = plt.subplots(figsize=self.figsize)
        else:
            fig = ax.figure

        # the drawn fields of one scenario, on the host in one copy each
        pos, heading, alive, is_cbv, shape = (
            to_numpy(getattr(state, k)[scenario])
            for k in ("pos", "heading", "alive", "is_cbv", "shape"))
        tick = int(to_numpy(state.tick[scenario]))
        center = pos[0]

        # lanes within view
        mid = self._centerline[:, self._centerline.shape[1] // 2]
        near = (np.linalg.norm(mid - center, axis=-1) < self.view_radius * 1.5) & self._valid
        for li in np.flatnonzero(near):
            ax.plot(*self._centerline[li].T, color=LANE_COLOR, lw=0.8, zorder=1)
            ax.plot(*self._left[li].T, color=EDGE_COLOR, lw=0.5, zorder=1)
            ax.plot(*self._right[li].T, color=EDGE_COLOR, lw=0.5, zorder=1)

        if route is not None:
            ax.plot(route[:, 0], route[:, 1], color=ROUTE_COLOR, lw=1.5, alpha=0.7, zorder=2)

        if reference_lines is not None:
            for line in reference_lines:
                ax.plot(line[:, 0], line[:, 1], "--", color=REFLINE_COLOR, lw=1.0, alpha=0.8,
                        zorder=2)

        if candidates is not None:
            for tr in candidates:
                ax.plot(tr[:, 0], tr[:, 1], color=CANDIDATE_COLOR, lw=0.7, alpha=0.5, zorder=3)

        corners = to_numpy(box_corners(*(torch.from_numpy(a) for a in (pos, heading, shape))))
        for a in np.flatnonzero(alive):
            color = EGO_COLOR if a == 0 else (CBV_COLOR if is_cbv[a] else BV_COLOR)
            ax.add_patch(MplPolygon(corners[a], closed=True, facecolor=color,
                                    edgecolor="black", lw=0.5, zorder=4))
            # heading tick
            tip = pos[a] + 3.0 * np.array([np.cos(heading[a]), np.sin(heading[a])])
            ax.plot([pos[a, 0], tip[0]], [pos[a, 1], tip[1]], color="black", lw=0.5, zorder=4)

        ax.set_xlim(center[0] - self.view_radius, center[0] + self.view_radius)
        ax.set_ylim(center[1] - self.view_radius, center[1] + self.view_radius)
        ax.set_aspect("equal")
        title = f"tick {tick}"
        if weather:
            # applied weather: rain and fog dim the scene (the BEV stand-in
            # for the leaderboard's dynamic weather); the HUD line records
            # what was applied
            rain = float(weather.get("precipitation", 0.0)) / 100.0
            fog = float(weather.get("fog_density", 0.0)) / 100.0
            cloud = float(weather.get("cloudiness", 0.0)) / 100.0
            dim = min(0.45, 0.35 * rain + 0.3 * fog + 0.1 * cloud)
            if dim > 0.0:
                r2 = 2 * self.view_radius
                ax.add_patch(MplPolygon(
                    np.array([[center[0] - r2, center[1] - r2], [center[0] + r2, center[1] - r2],
                              [center[0] + r2, center[1] + r2], [center[0] - r2, center[1] + r2]]),
                    closed=True, facecolor=WEATHER_TINT, alpha=dim, edgecolor="none", zorder=6,
                ))
            parts = [f"{k.replace('_', ' ')} {float(v):.0f}" for k, v in sorted(weather.items())
                     if k in HUD_KEYS and float(v) != 0.0]
            if parts:
                title += "  |  " + ", ".join(parts)
        ax.set_title(title, fontsize=9)
        return fig


class VideoRecorder:
    """Collects frames during a rollout; writes an mp4 (or a GIF) and the
    last frame as a PNG."""

    def __init__(self, tmap: TensorMap, out_dir: str, every_n_ticks: int = 5, **renderer_kw):
        _pil_image()
        self.renderer = BEVRenderer(tmap, **renderer_kw)
        self.out_dir = out_dir
        self.every = every_n_ticks
        self.frames: list[np.ndarray] = []
        os.makedirs(out_dir, exist_ok=True)

    def keeps(self, tick: int) -> bool:
        """Whether a state at `tick` becomes a frame: a caller that knows the
        tick on the host asks first, and reads nothing back from the device
        on the other ticks."""
        return tick % self.every == 0

    def maybe_capture(self, state, scenario: int = 0, tick: int | None = None, **render_kw):
        """Render `state` if its tick is a capture tick. `tick`, when given, is
        the scenes' tick as the host keeps it (TrafficEnv.tick); otherwise it
        is read from the state."""
        if tick is None:
            tick = int(to_numpy(state.tick[scenario]))
        if not self.keeps(tick):
            return
        plt = _pyplot()
        fig = self.renderer.render(state, scenario, **render_kw)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        self.frames.append(buf.copy())
        plt.close(fig)

    def save(self, name: str = "episode"):
        """Write the captured frames: mp4 when cv2 is there (its bundled
        mp4v encoder), a GIF otherwise, and `<name>_last.png`. Returns the
        video's path (None without frames) and drops the frames."""
        if not self.frames:
            return None
        Image = _pil_image()
        path = self._save_mp4(name)
        if path is None:
            imgs = [Image.fromarray(f) for f in self.frames]
            path = os.path.join(self.out_dir, f"{name}.gif")
            imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=100, loop=0)
        Image.fromarray(self.frames[-1]).save(os.path.join(self.out_dir, f"{name}_last.png"))
        self.frames = []
        return path

    def _save_mp4(self, name: str, fps: int = 10):
        try:
            import cv2
        except ImportError:
            return None
        path = os.path.join(self.out_dir, f"{name}.mp4")
        h, w = self.frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not vw.isOpened():
            return None
        for f in self.frames:
            vw.write(f[..., ::-1])  # RGB -> BGR
        vw.release()
        return path
