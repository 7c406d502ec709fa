"""The public API that the port's modules had left out, against the JAX
package on numpy-seeded inputs in f32 on the CPU: the 16 names of
`geometry/__init__.py`, the evaluator's `sparse_reward`,
`ref_line_matrices`, `grpo_advantage` and `grpo_advantage_batched`'s
debug outputs (with `pluto_cbv_act(adv_debug=True)` passing them on),
`TensorMap.lane_mid` and `lane_frame_speed_limit`, `init_sim_state` and
`build_features_for_agent`.

Tolerances: geometry 1e-6 on floats (inputs of unit scale), bools and
indices exactly; `sparse_reward`, `lane_mid`, `lane_frame_speed_limit` and
`init_sim_state` exactly; `ref_line_matrices` 1e-4 and the advantages,
returns and reward terms 1e-3 (the bounds, inputs and 20-frame horizon of
test_torch_evaluator_town.py and test_torch_evaluator_reward.py);
`build_features_for_agent` 1e-4, integers exactly (test_torch_pluto.py's
bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import rift_tpu.geometry as jgeo
import rift_tpu.rl as jrl
import rift_tpu_torch.geometry as tgeo
import rift_tpu_torch.rl as trl
from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.map import make_straight_town as jax_straight_town
from rift_tpu.models.pluto import build_features_for_agent as jax_features_for_agent
from rift_tpu.rl import evaluator as jev
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.sim.state import init_sim_state_host as jax_init_host
from rift_tpu_torch.map import make_straight_town
from rift_tpu_torch.models.pluto import PlutoModel, build_features_for_agent, pluto_cbv_act
from rift_tpu_torch.rl import evaluator as tev
from rift_tpu_torch.scenario import TrafficEnv, wake_all_bvs
from rift_tpu_torch.sim import init_sim_state
from test_torch_evaluator_reward import _advantage_inputs
from torch_parity import (
    assert_fields_match,
    map_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
    stepped_scene,
)

T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
N_FRAMES = 20


def _geometry_cases():
    """(name, numpy args) per function, from one numpy seed."""
    r = np.random.default_rng(0)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    ang = lambda *s: r.uniform(-np.pi, np.pi, s).astype(np.float32)
    shape = lambda *s: r.uniform(0.5, 2.0, s + (2,)).astype(np.float32)
    line = np.cumsum(np.abs(f(9, 2)) + 0.1, axis=0)
    line[4] = line[3]  # a zero-length segment
    valid = np.ones((5, 9), bool)
    valid[:, 7:] = False
    return [
        ("wrap_angle", (4.0 * f(64),)),
        ("rotate", (f(8, 2), ang(8))),
        ("rotation_matrix", (ang(3, 4),)),
        ("global_to_local", (f(6, 2), f(6, 2), ang(6))),
        ("local_to_global", (f(6, 2), f(6, 2), ang(6))),
        ("se2_compose", (f(7, 3), f(7, 3))),
        ("se2_inverse", (f(7, 3),)),
        ("box_corners", (f(5, 2), ang(5), shape(5))),
        ("obb_overlap", (f(64, 2), ang(64), shape(64), f(64, 2), ang(64), shape(64))),
        ("obb_overlap_matrix", (f(9, 2), ang(9), shape(9), f(11, 2), ang(11), shape(11))),
        ("point_in_obb", (f(64, 2), f(64, 2), ang(64), shape(64))),
        ("polyline_arclength", (f(3, 9, 2),)),
        ("resample_polyline", (line, 17)),
        ("polyline_headings", (f(3, 9, 2),)),
        ("nearest_point_index", (f(5, 9, 2), f(5, 2), valid)),
        ("project_point_to_polyline", (f(5, 9, 2), f(5, 2), valid)),
    ]


def test_geometry_matches_jax():
    """Every name of the JAX package's geometry exports exists in the
    port's and gives the JAX values; the optional masks are given, and
    `resample_polyline` meets a zero-length segment."""
    assert sorted(tgeo.__all__) == sorted(jgeo.__all__)
    cases = _geometry_cases()
    assert sorted(n for n, _ in cases) == sorted(jgeo.__all__)
    for name, args in cases:
        ref = getattr(jgeo, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                    for a in args))
        got = getattr(tgeo, name)(*(T(a) if isinstance(a, np.ndarray) else a for a in args))
        refs = ref if isinstance(ref, tuple) else (ref,)
        gots = got if isinstance(got, tuple) else (got,)
        for a, b in zip(refs, gots, strict=True):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (name, a.dtype, b.dtype)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)


def test_evaluator_api_matches_jax():
    """`sparse_reward`, `ref_line_matrices` (test_torch_evaluator_town.py's case),
    the single-CBV `grpo_advantage` on each CBV and the debug outputs of
    `grpo_advantage_batched` against the JAX package; the rl package
    exports them; the train act with `adv_debug` passes the same debug
    fields on and leaves every other output as it was."""
    for name in ("sparse_reward", "grpo_advantage", "ref_line_matrices"):
        assert name in jrl.__all__ and name in trl.__all__, name
    r = np.random.default_rng(2)
    coll, off = (r.random((4, 5)) < 0.5).astype(np.float32), r.random((4, 5)).astype(np.float32)
    np.testing.assert_array_equal(trl.sparse_reward(T(coll), T(off)).numpy(),
                                  np.asarray(jrl.sparse_reward(jnp.asarray(coll),
                                                               jnp.asarray(off))))

    rng = np.random.default_rng(5)
    R, M, Tn, Nr = 3, 4, 10, 17
    cand = (rng.normal(0, 20, (R, M, Tn, 2)).astype(np.float32),
            rng.uniform(-np.pi, np.pi, (R, M, Tn)).astype(np.float32))
    ref_pos = rng.normal(0, 20, (R, Nr, 2)).astype(np.float32)
    ref_heading = rng.uniform(-np.pi, np.pi, (R, Nr)).astype(np.float32)
    ref_valid = rng.random((R, Nr)) > 0.2
    ref_valid[:, 0] = True
    args = cand + (ref_pos, ref_heading, ref_valid)
    for a, b in zip(jev.ref_line_matrices(*map(jnp.asarray, args)),
                    tev.ref_line_matrices(*map(T, args)), strict=True):
        assert b.shape == (R, M, Tn)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)

    args, n = _advantage_inputs(N_FRAMES)
    jmap = jax_straight_town(length=400.0, num_lanes=2, pad_lanes_to=16)
    tmap = make_straight_town(length=400.0, num_lanes=2, pad_lanes_to=16, device="cpu")
    ref = jev.grpo_advantage_batched(jmap, *map(jnp.asarray, args), num_frames=n, debug=True)
    got = tev.grpo_advantage_batched(tmap, *map(T, args), num_frames=n, debug=True)
    assert sorted(got) == sorted(ref) and len(got) == 14
    for k in ref:
        a, b = np.asarray(ref[k]), got[k].numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, atol=1e-3, err_msg=k)
    for b in range(2):
        one = [a[b] for a in args]
        jone = jev.grpo_advantage(jmap, *map(jnp.asarray, one), num_frames=n)
        tone = tev.grpo_advantage(tmap, *map(T, one), num_frames=n)
        assert sorted(tone) == ["advantage", "rollout_return", "valid_mask"]
        for k in tone:
            assert tone[k].shape == (2, 3)
            np.testing.assert_allclose(tone[k].numpy(), np.asarray(jone[k]), atol=1e-3)
            # the wrapper is the batched evaluator's row (a batch of one
            # sums in another order: 1e-6)
            np.testing.assert_allclose(tone[k].numpy(), got[k][b].numpy(), atol=1e-6)

    # adv_debug through the train act (a depth-1 Pluto on legacy tokens)
    env_map = make_straight_town(length=400.0, num_lanes=2, device="cpu")
    env = TrafficEnv(env_map, num_scenarios=2, num_agents=6, max_cbvs=2, seed=1, device="cpu")
    state, _, spec = env.reset()
    state = wake_all_bvs(state)
    state = state.replace(is_cbv=state.is_cbv.index_fill(1, torch.tensor([1]), True) & state.alive)
    torch.manual_seed(0)
    model = PlutoModel(encoder_depth=1, decoder_depth=1, dtype=torch.float32, device="cpu").eval()
    plain = pluto_cbv_act(model, env_map, spec, state, max_cbvs=2, train=True)
    dbg = pluto_cbv_act(model, env_map, spec, state, max_cbvs=2, train=True, adv_debug=True)
    dbg_keys = sorted(k for k in dbg if k.startswith("dbg_"))
    assert dbg_keys == sorted(k for k in ref if k.startswith("dbg_"))
    assert sorted(set(dbg) - set(dbg_keys)) == sorted(plain)
    for k in ("advantage", "rollout_return", "adv_valid", "old_logits", "traj"):
        assert torch.equal(dbg[k], plain[k]), k
    S, C, RR, MM = plain["advantage"].shape
    for k in dbg_keys:
        assert dbg[k].shape == (S, C, RR, MM) and torch.isfinite(dbg[k].float()).all(), k


def test_map_state_and_features_match_jax():
    """`lane_mid`, `lane_frame_speed_limit` and `init_sim_state` exactly;
    `build_features_for_agent` on a scene of four ticks for each (scenario,
    agent) pair of a few, legacy and canonical."""
    jmap = jax_grid_town(blocks=1, num_lanes=2)
    tmap = map_from_jax(jmap)
    np.testing.assert_array_equal(tmap.lane_mid.numpy(), np.asarray(jmap.lane_mid))
    lanes = np.array([0, 3, 7, 11, 3], np.int32)
    np.testing.assert_array_equal(tmap.lane_frame_speed_limit(T(lanes).long()).numpy(),
                                  np.asarray(jmap.lane_frame_speed_limit(jnp.asarray(lanes))))

    rng_keys = np.arange(6, dtype=np.uint32).reshape(3, 2)
    st = init_sim_state(3, 5, rng=rng_keys, device="cpu")
    jst = jax_init_host(3, 5, rng=rng_keys)
    assert st.pos.device.type == "cpu"
    assert_fields_match(jst, st, atol=0.0)

    S, A = 2, 6
    env = JaxTrafficEnv(jmap, num_scenarios=S, num_agents=A, max_cbvs=2, seed=3)
    jstate, jcrit, jspec = env.reset()
    jstate, _ = stepped_scene(jmap, jstate, jcrit, jspec, 4, 2)
    jstate = jax_wake(jstate)
    state, spec = state_from_jax(jstate), spec_from_jax(jspec)
    for canonical in (False, True):
        jfn = jax.jit(lambda st, s, a, rm, ch, c=canonical: jax_features_for_agent(
            jmap, st, s, a, rm, ch, canonical=c))
        for s, a in ((0, 1), (1, 3), (1, 0)):
            ref = jfn(jstate, jnp.int32(s), jnp.int32(a), jspec.route_lane_mask[s],
                      jspec.lane_chains[s])
            got = build_features_for_agent(tmap, state, s, a, spec.route_lane_mask[s],
                                           spec.lane_chains[s], canonical=canonical)
            assert sorted(got) == sorted(ref)
            for g in ref:
                for k in (ref[g] if isinstance(ref[g], dict) else [None]):
                    x = np.asarray(ref[g][k] if k else ref[g])
                    y = (got[g][k] if k else got[g]).numpy()
                    name = f"{canonical}:{s},{a}:{g}.{k}"
                    assert x.shape == y.shape, name
                    if x.dtype.kind in "biu":
                        np.testing.assert_array_equal(y, x, err_msg=name)
                    else:
                        np.testing.assert_allclose(y, x, atol=1e-4, err_msg=name)
