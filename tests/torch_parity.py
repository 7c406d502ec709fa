"""Shared helpers of the rift_tpu_torch tests: JAX pytrees become the
port's tensor dataclasses through numpy, numpy-seeded kernel inputs, and
the one-thread fixture of the CPU tests. Imports neither jax nor rift_tpu,
so the card-only tests can use it."""

import dataclasses

import numpy as np
import pytest
import torch

from rift_tpu_torch.map.tensor_map import TensorMap
from rift_tpu_torch.scenario.criteria import CriteriaState
from rift_tpu_torch.sim.pid import PIDState, TrackerState
from rift_tpu_torch.sim.state import ScenarioSpec, SimState


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for a CPU test module (imported by name into
    it): the port's CPU paths are thousands of tiny ops, and torch's thread
    pool, spinning against the other test processes' threads on a loaded
    host, slows them by 20-40x. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_fields(cls, obj, skip=()):
    return {
        f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
        for f in dataclasses.fields(cls)
        if f.name not in skip
    }


def map_from_jax(jmap, device="cpu") -> TensorMap:
    """The port's TensorMap holding a JAX TensorMap's arrays (the two
    grid towns agree bit for bit: tests/test_torch_map.py)."""
    return TensorMap(**_np_fields(TensorMap, jmap)).to(device)


def crit_from_jax(jcrit, device="cpu") -> CriteriaState:
    return CriteriaState(**_np_fields(CriteriaState, jcrit)).to(device)


def state_from_jax(js, device="cpu") -> SimState:
    """The port's SimState holding the values of a JAX SimState."""
    kw = _np_fields(SimState, js, skip=("tracker",))
    pid = lambda p: PIDState(*(np.asarray(x) for x in p))
    kw["tracker"] = TrackerState(pid(js.tracker.speed), pid(js.tracker.turn))
    return SimState(**kw).to(device)


def spec_from_jax(jspec, device="cpu") -> ScenarioSpec:
    return ScenarioSpec(**_np_fields(ScenarioSpec, jspec)).to(device)


def to_jax(tobj, jtemplate):
    """A JAX container like `jtemplate` (a SimState, CriteriaState or
    ScenarioSpec, with its trackers) holding a port container's values, in
    the template's dtypes."""
    import jax.numpy as jnp

    if isinstance(jtemplate, tuple):  # the trackers' NamedTuples
        return type(jtemplate)(*(to_jax(getattr(tobj, k), getattr(jtemplate, k))
                                 for k in jtemplate._fields))
    if dataclasses.is_dataclass(jtemplate):
        return jtemplate.replace(**{f.name: to_jax(getattr(tobj, f.name),
                                                   getattr(jtemplate, f.name))
                                    for f in dataclasses.fields(jtemplate)})
    if not isinstance(tobj, torch.Tensor):
        return jtemplate
    return jnp.asarray(tobj.numpy().astype(np.asarray(jtemplate).dtype))


def stepped_scene(jmap, jstate, jcrit, jspec, ticks, max_cbvs=3, ego=None):
    """`ticks` env steps from a JAX scene, run by the port's env
    (test_torch_env holds it to the JAX one) to spare the JAX env step's
    compile: the JAX (state, crit) after them. `ego(spec, state, tmap)`:
    the port's ego waypoints for each step (env_step's rule ego if None)."""
    from rift_tpu_torch.scenario import TrafficEnv

    S, A = jstate.alive.shape
    tmap = map_from_jax(jmap)
    env = TrafficEnv(tmap, num_scenarios=S, num_agents=A, max_cbvs=max_cbvs, device="cpu")
    env.spec = spec_from_jax(jspec)
    state, crit = state_from_jax(jstate), crit_from_jax(jcrit)
    for _ in range(ticks):
        kw = {} if ego is None else {"ego_traj": ego(env.spec, state, tmap)}
        state, crit = env.step(state, crit, **kw)
    return to_jax(state, jstate), to_jax(crit, jcrit)


def assert_fields_match(jobj, tobj, atol, rtol=0.0, prefix=""):
    """Every field of a port container (SimState, CriteriaState, nested
    trackers, ScenarioSpec, TensorMap) against the JAX one: integer and bool fields exactly (uint32
    and int32 values as the port's int64), float fields within atol/rtol
    with NaN where the JAX value is NaN."""
    for f in dataclasses.fields(tobj):
        a, b = getattr(jobj, f.name), getattr(tobj, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(b):
            assert_fields_match(a, b, atol, rtol, name + ".")
            continue
        if b is None:  # an optional field (a spec's visibility) unset in both
            assert a is None, name
            continue
        a, b = np.asarray(a), b.detach().cpu().numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)


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


# the HistoryEncoder's three levels on the main path: (T, D, H, window)
STAGE_LEVELS = {"level0": (20, 32, 2, 3), "level1": (10, 64, 4, 3), "level2": (5, 128, 8, 5)}


def stage_inputs(seed, N, T, D, H, window):
    """One stage's operands from a numpy seed: x [N, T, D], the 24 block
    weights (LN scales near 1, fan-in scaled matrices) and the two blocks'
    RPB tables [H, 2w-1] (numpy f32)."""
    from rift_tpu_torch.ops.history import STAGE_WNAMES, weight_shapes

    r = np.random.default_rng(seed)
    x = r.normal(size=(N, T, D)).astype(np.float32)
    ws = []
    for name, s in zip(STAGE_WNAMES * 2, weight_shapes(D) * 2):
        if name.endswith("scale"):
            a = 1.0 + 0.1 * r.normal(size=s)
        elif len(s) == 1:
            a = 0.1 * r.normal(size=s)
        else:
            a = r.normal(size=s) / np.sqrt(s[0])
        ws.append(a.astype(np.float32))
    rpb = [(0.5 * r.normal(size=(H, 2 * window - 1))).astype(np.float32) for _ in range(2)]
    return x, ws, rpb


def write_route_file(path, ids=(1, 2, 3, 4)):
    """A small route file in the Bench2Drive schema (routes of waypoints
    with weather keyframes at 0 and 100 % of the route), in town
    coordinates km apart: a straight route (id 1), an L with one corner
    (id 2, a junction in the route town) and a crossing pair (ids 3 and 4,
    within 100 m of each other, so a data loader batches them apart; a
    shared junction in the shared town). `ids` picks the routes written."""
    straight = [(1000.0 + 50.0 * i, 200.0) for i in range(7)]
    ell = [(0.0, 0.0), (150.0, 0.0), (150.0, 150.0)]
    cross_a = [(5000.0, 5000.0 + 40.0 * i) for i in range(8)]
    cross_b = [(4860.0 + 40.0 * i, 5140.0) for i in range(8)]
    routes = {1: (straight, 0, 40), 2: (ell, 10, 0), 3: (cross_a, 0, 0), 4: (cross_b, 60, 80)}
    body = []
    for rid in ids:
        pts, fog, rain = routes[rid]
        wps = "".join(f'<position x="{x}" y="{y}" z="0.0"/>' for x, y in pts)
        body.append(
            f'<route id="{rid}" town="Town12"><weathers>'
            f'<weather route_percentage="0" cloudiness="10.0" precipitation="0.0" '
            f'fog_density="{fog}"/>'
            f'<weather route_percentage="100" cloudiness="60.0" precipitation="{rain}" '
            f'fog_density="{fog}"/>'
            f"</weathers><waypoints>{wps}</waypoints></route>")
    with open(path, "w") as f:
        f.write("<routes>\n" + "\n".join(body) + "\n</routes>\n")
    return str(path)


def eval_results_files(runs, S=2, A=6, ticks=30):
    """For each (path, seed) of `runs`, a `simulation_results.json` of one
    eval episode of the port's env on the CPU (one straight town, the rule
    ego, S scenarios of A agents, from `seed`; CBVs from tick 26), written
    by the port's StatisticsManager. Returns the paths."""
    from rift_tpu_torch.map import make_straight_town
    from rift_tpu_torch.scenario import TrafficEnv
    from rift_tpu_torch.scenario.statistics import StatisticsManager

    tm = make_straight_town(length=300.0, num_lanes=2, device="cpu")
    for path, seed in runs:
        env = TrafficEnv(tm, num_scenarios=S, num_agents=A, seed=seed, device="cpu")
        state, crit, spec = env.reset()
        for _ in range(ticks):
            state, crit = env.step(state, crit)
        StatisticsManager(str(path)).register_episode(crit, state, spec)
    return [str(path) for path, _ in runs]


def load_tool(path, name):
    """A script module loaded from its file under `name` (the JAX package's
    tools/ are scripts, not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
