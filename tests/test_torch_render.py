"""The port's BEV renderer, video recorder and `--render` CLI path
(rift_tpu_torch/viz/render.py, run.py) against the JAX package's
(rift_tpu/viz/render.py, rift_tpu/run.py:783-818), on the CPU.

The scene comes from the port (a reset of the small grid town, CBVs on
slots 1 and 2) and reaches the JAX renderer as numpy, so no JAX program is
compiled beyond the renderer's eager `box_corners`. Frames: equal RGB
arrays (observed: not one pixel of 800 x 800 apart), with room only for
the two box-corner computations (XLA's and torch's f32 sin and cos) to
differ in the last ulp on another CPU, which moves an edge by ~1e-5 m
(~1e-4 px) and an antialiased pixel's value by at most 2 of 255: at most
0.1% of the pixels may differ, by at most 2.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from rift_tpu.viz import render as jax_render
from rift_tpu_torch import run
from rift_tpu_torch.map import make_grid_town
from rift_tpu_torch.scenario import TrafficEnv, wake_all_bvs
from rift_tpu_torch.viz import BEVRenderer, VideoRecorder
from torch_parity import one_torch_thread  # noqa: F401

PIXELS_APART, PIXEL_DIFF = 1e-3, 2
RAIN = {"precipitation": 60.0, "fog_density": 20.0, "cloudiness": 50.0, "wetness": 30.0,
        "sun_altitude_angle": 45.0, "wind_intensity": 10.0}


@pytest.fixture(scope="module")
def scene():
    """The port's small grid town and a reset of 2 scenarios with CBVs on
    slots 1 and 2; the route of scenario 0, three candidate trajectories
    and two reference lines (the second NaN-padded) in the world frame."""
    tmap = make_grid_town(blocks=1, num_lanes=2, device="cpu")
    env = TrafficEnv(tmap, num_scenarios=2, num_agents=10, seed=5, device="cpu")
    state, _, spec = env.reset()
    state = wake_all_bvs(state)
    is_cbv = state.is_cbv.clone()
    is_cbv[:, 1:3] = state.alive[:, 1:3]
    state = state.replace(is_cbv=is_cbv, tick=torch.full_like(state.tick, 35))
    r = np.random.default_rng(0)
    ego = state.pos[0, 0].numpy()
    steps = np.stack([np.full((3, 20), 1.5), r.normal(0, 0.3, (3, 20))], -1).cumsum(1)
    cands = (ego + steps).astype(np.float32)
    lines = (ego + np.stack([np.linspace(-20, 40, 30), np.full(30, 3.5)], -1)
             + np.array([[[0, 0]], [[0, -7]]])).astype(np.float32)
    lines[1, 20:] = np.nan
    route = spec.ego_route[0, :int(spec.ego_route_len[0]), :2].numpy()
    return tmap, state, dict(route=route, candidates=cands, reference_lines=lines)


def _as_numpy(obj, fields):
    return types.SimpleNamespace(**{f: getattr(obj, f).numpy() for f in fields})


def _jax_inputs(tmap, state):
    return (_as_numpy(tmap, ("centerline", "left_edge", "right_edge", "valid")),
            _as_numpy(state, ("pos", "heading", "alive", "is_cbv", "shape", "tick")))


def _rgb(fig):
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    jax_render.plt.close(fig)
    return out


def _assert_frames_close(got, want):
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (diff > 0).mean() <= PIXELS_APART and diff.max() <= PIXEL_DIFF, (
        (diff > 0).mean(), diff.max())


def test_bev_frame_matches_jax(scene):
    """One frame of scenario 0 and one of scenario 1, with CBVs, the route,
    candidates, reference lines and rain: the port's pixels are the JAX
    renderer's (the tolerance above); without weather too."""
    tmap, state, kw = scene
    jmap, jstate = _jax_inputs(tmap, state)
    port, ref = BEVRenderer(tmap), jax_render.BEVRenderer(jmap)
    assert int(state.is_cbv[0].sum()) >= 1 and int(state.alive[0].sum()) >= 4
    for scenario, weather in ((0, RAIN), (1, None)):
        want = _rgb(ref.render(jstate, scenario, weather=weather, **kw))
        got = _rgb(port.render(state, scenario, weather=weather, **kw))
        _assert_frames_close(got, want)
        assert (got != 255).any(-1).mean() > 0.02  # drawn, not blank
    plain = _rgb(port.render(state, 0, **kw))
    assert np.abs(plain.astype(int) - got.astype(int)).sum() > 0


def test_video_recorder_matches_jax(scene, tmp_path, monkeypatch):
    """Both recorders capture on the same ticks (every 5th of ticks 0-11:
    0, 5 and 10), with frames equal within the tolerance; each writes the
    mp4 and `<name>_last.png` with cv2, the GIF and the PNG without it
    (the same files, the same frame counts). Without matplotlib or Pillow
    the port's recorder raises an ImportError naming the package."""
    import cv2
    from PIL import Image

    tmap, state, kw = scene
    jmap, jstate = _jax_inputs(tmap, state)
    dirs = {k: str(tmp_path / k) for k in ("port", "jax", "port_gif", "jax_gif")}
    recs = {"port": VideoRecorder(tmap, dirs["port"]),
            "jax": jax_render.VideoRecorder(jmap, dirs["jax"]),
            "port_gif": VideoRecorder(tmap, dirs["port_gif"]),
            "jax_gif": jax_render.VideoRecorder(jmap, dirs["jax_gif"])}
    for tick in range(12):
        st = state.replace(tick=torch.full_like(state.tick, tick))
        jst = types.SimpleNamespace(**{**jstate.__dict__, "tick": st.tick.numpy()})
        for name, rec in recs.items():
            rec.maybe_capture(jst if name.startswith("jax") else st, 0, **kw)
    assert [len(r.frames) for r in recs.values()] == [3] * 4
    for a, b in zip(recs["port"].frames, recs["jax"].frames):
        _assert_frames_close(a, b)
    last = recs["port"].frames[-1]
    assert recs["port"].save("ep0").endswith("ep0.mp4")
    assert recs["jax"].save("ep0").endswith("ep0.mp4")
    monkeypatch.setitem(sys.modules, "cv2", None)  # cv2 absent: the GIF
    assert recs["port_gif"].save("ep0").endswith("ep0.gif")
    assert recs["jax_gif"].save("ep0").endswith("ep0.gif")
    for port, ref in (("port", "jax"), ("port_gif", "jax_gif")):
        assert sorted(os.listdir(dirs[port])) == sorted(os.listdir(dirs[ref]))
    _assert_frames_close(np.asarray(Image.open(os.path.join(dirs["port"], "ep0_last.png"))),
                         last)
    monkeypatch.delitem(sys.modules, "cv2")
    counts = [int(cv2.VideoCapture(os.path.join(dirs[d], "ep0.mp4")).get(
        cv2.CAP_PROP_FRAME_COUNT)) for d in ("port", "jax")]
    assert counts == [3, 3]
    gifs = [Image.open(os.path.join(dirs[d], "ep0.gif")).n_frames for d in ("port_gif", "jax_gif")]
    assert gifs == [3, 3]
    assert recs["port"].save("ep1") is None and recs["port"].frames == []
    for missing in ("matplotlib", "PIL"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, missing, None)
            with pytest.raises(ImportError, match=missing.replace("PIL", "Pillow")):
                VideoRecorder(tmap, str(tmp_path / "none"))


def _world_frame_numpy(cbv_out, prev_state):
    """rift_tpu/run.py:797-811, transcribed: scenario 0's executed CBV
    trajectories, local -> world frame."""
    mask = np.asarray(cbv_out["mask"][0])
    if not mask.any():
        return None
    tr = np.asarray(cbv_out["traj"][0][mask])  # [K, T, 2]
    hd = np.asarray(prev_state.heading[0])[mask]
    ps = np.asarray(prev_state.pos[0])[mask]
    c, s = np.cos(hd)[:, None], np.sin(hd)[:, None]
    return np.stack([tr[..., 0] * c - tr[..., 1] * s + ps[:, None, 0],
                     tr[..., 0] * s + tr[..., 1] * c + ps[:, None, 1]], axis=-1)


def test_cli_render(tmp_path, monkeypatch, capsys):
    """`run.main --mode eval --render --device cpu` for 30 ticks at S=2: the
    per-tick loop (never the fused one), a frame every 5 ticks (6), and
    `video_ep0/ep0.mp4` with `ep0_last.png`; the observer reads the
    device only on capture ticks, and its world-frame candidates equal the
    numpy transcription of the JAX CLI's (1e-5 m), CBVs acting on some of
    them (recognition from tick 26; with `--seed 4` and 16 agents scenario
    0 has CBVs from the frame of tick 30)."""
    seen, saved = [], []
    frame_fn = run.world_frame_candidates

    def recorded(cbv_out, prev_state, scenario=0):
        got = frame_fn(cbv_out, prev_state, scenario)
        seen.append((got, _world_frame_numpy(cbv_out, prev_state)))
        return got

    save = VideoRecorder.save

    def counted(self, name="episode"):
        saved.append(len(self.frames))
        return save(self, name)

    def no_fused(*a, **k):
        raise AssertionError("--render must run the per-tick loop")

    monkeypatch.setattr(run, "world_frame_candidates", recorded)
    monkeypatch.setattr(VideoRecorder, "save", counted)
    monkeypatch.setattr(run, "run_episode_fused", no_fused)
    out = str(tmp_path / "log")
    run.main(["--mode", "eval", "--render", "--device", "cpu", "--ego_cfg", "behavior",
              "--seed", "4", "--blocks", "1", "--num_scenario", "2", "--num_agents", "16",
              "--num_episodes", "1", "--max_ticks", "30", "--out_dir", out, "encoder_depth=1",
              "decoder_depth=1"])
    video = os.path.join(out, "eval", "behavior-rift_pluto-seed4", "video_ep0")
    assert sorted(os.listdir(video)) == ["ep0.mp4", "ep0_last.png"]
    assert f"episode 0: wrote {os.path.join(video, 'ep0.mp4')}" in capsys.readouterr().out
    assert saved == [30 // 5] and len(seen) == 30 // 5
    acted = [(g, w) for g, w in seen if w is not None]
    assert acted and all(g is None for g, w in seen if w is None)
    for got, want in acted:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
