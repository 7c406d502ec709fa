"""Shared helpers of the rift_tpu_torch tests: JAX pytrees become the
port's tensor dataclasses through numpy, and numpy-seeded kernel inputs.
Imports neither jax nor rift_tpu, so the card-only tests can use it."""

import dataclasses

import numpy as np

from rift_tpu_torch.sim.pid import PIDState, TrackerState
from rift_tpu_torch.sim.state import ScenarioSpec, SimState


def _np_fields(cls, obj, skip=()):
    return {
        f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
        for f in dataclasses.fields(cls)
        if f.name not in skip
    }


def state_from_jax(js, device="cpu") -> SimState:
    """The port's SimState holding the values of a JAX SimState."""
    kw = _np_fields(SimState, js, skip=("tracker",))
    pid = lambda p: PIDState(*(np.asarray(x) for x in p))
    kw["tracker"] = TrackerState(pid(js.tracker.speed), pid(js.tracker.turn))
    return SimState(**kw).to(device)


def spec_from_jax(jspec, device="cpu") -> ScenarioSpec:
    return ScenarioSpec(**_np_fields(ScenarioSpec, jspec)).to(device)


def assert_same(a, b, name=""):
    """Integer and bool arrays bit for bit; float arrays exactly."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


# one case per main-path shape family: (B, Tq, Tk, D, H)
ATTN_CASES = {
    "state_tq1": (6, 1, 6, 64, 4),  # StateAttentionEncoder, Dh=16
    "r2r_t4": (12, 4, 4, 64, 2),  # Dh=32
    "m2m_t12": (8, 12, 12, 64, 4),
    "history_t20": (10, 20, 20, 32, 2),  # Dh=16
    "cross_48x97": (3, 48, 97, 128, 4),  # Dh=32
}


def attn_inputs(B, Tq, Tk, D, H, seed=0):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(0, 1, s).astype(np.float32) for s in
               ((B, Tq, D), (B, Tk, D), (B, Tk, D)))
    bias = r.normal(0, 0.5, (H, Tq, Tk)).astype(np.float32)
    kpad = np.where(r.random((B, Tk)) < 0.3, -1e9, 0.0).astype(np.float32)
    kpad[0] = -1e9  # a fully masked row: uniform weights, not NaN
    return q, k, v, bias, kpad


def points_weights(seed, C, out_dim):
    r = np.random.default_rng(seed)
    mk = lambda *s: r.normal(0, 0.3, s).astype(np.float32)
    return (
        mk(C, 128), mk(128), np.abs(mk(128)) + 0.5, mk(128),
        mk(128, 256), mk(256),
        mk(512, 256), mk(256), np.abs(mk(256)) + 0.5, mk(256),
        mk(256, out_dim), mk(out_dim),
    )
