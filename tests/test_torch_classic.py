"""The per-tick loop's raw controls and the classic PPO stack of the port
against the JAX package, on the CPU, on weights carried across
(`load_ppo_params`):
- `cbv_normal_obs` and `ego_normal_obs` on a scene with distance ties,
  dead agents, a CBV with no other agent alive and an ego with fewer than
  two; the `ppo` CBV's act (deterministic) with an invalid slot: its
  controls scattered to the CBV slots;
- both action conversions and both rewards; `gaussian_log_prob`;
  `ClassicPPO.act` (deterministic) and `value`; ten `train` epochs on one
  batch (losses and weights); `_gae_batch` on a trajectory with dones and
  invalid steps;
- `run_episode` with the `ppo` ego and the `ppo` CBVs in eval on
  test_torch_world's scene (CBVs forced on both sides), every tick's acts
  and the final state and criteria field by field: `ego_ctrl` and
  `cbv_ctrl` reach the world.
Tolerances: 1e-5 (atol and rtol) for the functions and the PPO round
(optax's Adam and torch's, the same arithmetic rounded apart); the closed
loop as test_torch_env's (integer and bool fields exactly, floats 1e-4).
The port's own per-tick paths are in test_torch_per_tick.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rift_tpu import policies as jax_policies
from rift_tpu import run as jax_run
from rift_tpu.rl import classic as jc
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.sim.state import init_sim_state_host
from rift_tpu_torch import policies, run
from rift_tpu_torch.rl import classic as tc
from rift_tpu_torch.scenario import TrafficEnv
from rift_tpu_torch.utils.params_io import load_ppo_params
from test_torch_world import C, jax_scene
from torch_parity import (
    assert_fields_match,
    crit_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
)

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = types.SimpleNamespace(device=torch.device("cpu"))  # a map for map-free policies


def _jitted_act(pol):
    """The JAX policy's deterministic `act` under one jit (its code, with
    its params and rng as the program's arguments): one compile instead
    of an eager compile per primitive. Deterministic also where the loop
    asks for a train act."""
    def pure(params, rng, spec, state):
        pol.ppo.params, pol.rng = params, rng
        return type(pol).act(pol, spec, state)

    act = jax.jit(pure)

    def call(spec, state, train=False):
        params, rng = pol.ppo.params, pol.rng
        out = act(params, rng, spec, state)
        pol.ppo.params, pol.rng = params, rng
        return out

    return call


def _jitted_project(tmap):
    """The JAX map as train_ego_episode reads it: its `project` under one
    jit (one compile instead of an eager compile per primitive)."""
    proj = jax.jit(lambda m, lane, pos: m.project(lane, pos))
    return types.SimpleNamespace(project=lambda lane, pos: proj(tmap, lane, pos))


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=name, **TOL)


def _obs_scene():
    """S=3, A=6, host numpy. Scenario 0: agents 1 and 2 equally far from
    the ego and from CBV 3, agent 5 dead. Scenario 1: only the ego and
    agent 4 alive (the ego has one other), CBV 4 has no other agent alive
    but the ego. Scenario 2: only the ego and CBV 1 alive."""
    st = init_sim_state_host(3, 6)
    r = np.random.default_rng(3)
    st.pos[:] = r.uniform(-30, 30, st.pos.shape).astype(np.float32)
    st.pos[0, :4] = [[0, 0], [10, 0], [0, 10], [10, 10]]
    st.heading[:] = r.uniform(-3, 3, st.heading.shape).astype(np.float32)
    st.speed[:] = r.uniform(0, 10, st.speed.shape).astype(np.float32)
    st.shape[:] = r.uniform(1.5, 5, st.shape.shape).astype(np.float32)
    st.goal[:] = r.uniform(-60, 60, st.goal.shape).astype(np.float32)
    st.alive[:] = [[1, 1, 1, 1, 1, 0], [1, 0, 0, 0, 1, 0], [1, 1, 0, 0, 0, 0]]
    st.is_cbv[:] = [[0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 1, 0], [0, 1, 0, 0, 0, 0]]
    return st


def test_observations_and_cbv_act_match_jax():
    host = _obs_scene()
    jst, st = jax.device_put(host), state_from_jax(host)
    slots = np.array([[3, 1, 2], [4, 0, 5], [1, 3, 0]])
    want = jax.jit(jax.vmap(jax.vmap(jc.cbv_normal_obs, (None, None, 0)), (None, 0, 0)))(
        jst, jnp.arange(3), jnp.asarray(slots))
    _close(tc.cbv_normal_obs(st, torch.from_numpy(slots)), want, "cbv_normal_obs")
    assert not np.asarray(want)[2, 0, 2].any()  # no other alive: the row is zeroed
    wp = np.array([[5.0, 1.0], [-3.0, 7.0], [20.0, -4.0]], np.float32)
    _close(tc.ego_normal_obs(st, torch.from_numpy(wp)),
           jax.jit(jc.ego_normal_obs)(jst, jnp.asarray(wp)), "ego_normal_obs")

    # the ppo CBV's act: an invalid slot in every scenario (C=2 > the
    # CBVs); raw controls only at the CBVs, never at the ego
    jpol = jax_policies.ClassicCBVPolicy(None, {"max_cbvs": 2})
    pol = policies.ClassicCBVPolicy(CPU, {"max_cbvs": 2})
    load_ppo_params(pol.ppo.actor, pol.ppo.critic, jpol.ppo.params)
    want, got = _jitted_act(jpol)(None, jst), pol.act(None, st)
    assert np.asarray(got["cbv_slots"]).tolist() == np.asarray(want["cbv_slots"]).tolist()
    assert torch.equal(got["mask"], torch.from_numpy(np.asarray(want["mask"])))
    assert got["mask"].sum() == 3 and not got["mask"][:, 0].any()
    for k in ("ctrl", "obs", "logp", "action", "value"):
        _close(got[k], want[k], k)


def test_actions_rewards_ppo_and_gae_batch_match_jax():
    r = np.random.default_rng(0)
    a = r.uniform(-1.2, 1.2, (64, 2)).astype(np.float32)
    ctrl = np.asarray(jc.rl_action_to_control(a))
    _close(tc.rl_action_to_control(torch.from_numpy(a)), ctrl, "rl_action_to_control")
    _close(tc.control_to_rl_action(torch.from_numpy(ctrl)), jc.control_to_rl_action(ctrl),
           "control_to_rl_action")
    d0, d1 = (r.uniform(0, 20, 64).astype(np.float32) for _ in range(2))
    hit, reach = r.random(64) < 0.3, r.random(64) < 0.3
    _close(tc.cbv_full_train_reward(*map(torch.from_numpy, (d0, d1, hit, reach))),
           jc.cbv_full_train_reward(d0, d1, hit, reach), "cbv_full_train_reward")
    v, steer, lat = (r.uniform(-1, 12, 64).astype(np.float32), a[:, 1] * 0.3,
                     r.uniform(-6, 6, 64).astype(np.float32))
    _close(tc.ego_shaped_reward(*map(torch.from_numpy, (v, steer, lat, hit))),
           jc.ego_shaped_reward(v, steer, lat, hit), "ego_shaped_reward")

    jppo = jc.ClassicPPO(epochs=10)
    ppo = tc.ClassicPPO(epochs=10, device="cpu")
    load_ppo_params(ppo.actor, ppo.critic, jppo.params)
    B = 48
    obs = r.normal(0, 5, (B, 4, 6)).astype(np.float32)
    mean, log_std = (r.normal(0, 0.5, s).astype(np.float32) for s in ((B, 2), (2,)))
    _close(tc.gaussian_log_prob(*map(torch.from_numpy, (mean, log_std, a[:B]))),
           jc.gaussian_log_prob(mean, log_std, a[:B]), "gaussian_log_prob")
    ja, jlp = jppo.act(jppo.params, obs, None, deterministic=True)
    ta, tlp = ppo.act(torch.from_numpy(obs), deterministic=True)
    _close(ta, ja, "act")
    _close(tlp, jlp, "act logp")
    _close(ppo.value(torch.from_numpy(obs)), jppo.value(jppo.params, obs), "value")
    batch = {"obs": obs, "action": a[:B], "old_log_prob": np.asarray(jlp) - 0.1,
             "advantage": r.normal(0, 2, B).astype(np.float32),
             "returns": r.normal(0, 3, B).astype(np.float32)}
    want = jppo.train({k: jnp.asarray(x) for k, x in batch.items()})
    got = ppo.train({k: torch.from_numpy(x) for k, x in batch.items()})
    _close(got, want, "losses")
    for part, mod in (("actor", ppo.actor), ("critic", ppo.critic)):
        tree = getattr(jppo.params, part)["params"]
        for name, p in mod.named_parameters():
            *mods, leaf = name.split(".")
            ref = tree[mods[0]][{"weight": "kernel"}.get(leaf, leaf)] if mods else tree[leaf]
            ref = np.asarray(ref)
            _close(p.detach().numpy(), ref.T if leaf == "weight" else ref, f"{part}.{name}")

    r = np.random.default_rng(1)  # _gae_batch on a trajectory with dones and invalid steps
    T, B = 12, 5
    traj = {"obs": r.normal(size=(T, B, 4, 6)), "action": r.normal(size=(T, B, 2)),
            "logp": r.normal(size=(T, B)), "value": r.normal(size=(T, B)),
            "reward": r.normal(size=(T, B)), "done": r.random((T, B)) < 0.15,
            "valid": r.random((T, B)) < 0.8}
    traj = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in traj.items()}
    boot = r.normal(size=B).astype(np.float32)
    coeffs = types.SimpleNamespace(gamma=0.98, lam=0.95)
    want, n_want = jax_run._gae_batch(coeffs, traj, boot)
    got, n = run._gae_batch(coeffs, {k: torch.from_numpy(v) for k, v in traj.items()},
                            torch.from_numpy(boot))
    assert n == n_want and 0 < n < T * B
    for k in want:
        _close(got[k], want[k], k)


def test_run_episode_with_raw_controls_matches_jax():
    """The `ppo` ego and the `ppo` CBVs, deterministic, from
    test_torch_world's scene: 8 ticks through each package's
    train_ego_episode, then 8 from the same scene through its
    train_classic_cbv_episode (both on run_episode). Every tick's acts, the
    final states and criteria field by field, and the GAE batch that each
    episode hands to its policy's train_round (recorded, not fitted)."""
    sc = jax_scene()
    S, A = sc["jstate"].alive.shape
    jenv = JaxTrafficEnv(sc["jmap"], num_scenarios=S, num_agents=A, max_cbvs=C)
    jenv.spec = sc["jspec"]
    env = TrafficEnv(sc["tmap"], num_scenarios=S, num_agents=A, max_cbvs=C, device="cpu")
    env.spec = spec_from_jax(sc["jspec"])
    tick0 = env.tick
    pols = {"jax": (jax_policies.EgoPPO(sc["jmap"], {}),
                    jax_policies.ClassicCBVPolicy(sc["jmap"], {"max_cbvs": C})),
            "torch": (policies.EgoPPO(sc["tmap"], {}),
                      policies.ClassicCBVPolicy(sc["tmap"], {"max_cbvs": C}))}
    acts = {"jax": [], "torch": []}  # each tick's (policy, act output)
    batches = {"jax": [], "torch": []}  # each train_round's (policy, batch)
    for key, (ego, cbv) in pols.items():
        for name, pol in (("ego", ego), ("cbv", cbv)):
            if key == "jax":
                act = _jitted_act(pol)
            else:
                jpol = pols["jax"][name == "cbv"]
                load_ppo_params(pol.ppo.actor, pol.ppo.critic, jpol.ppo.params)
                act = pol.act

            def recorded(spec, state, train=False, _act=act, _rec=acts[key], _name=name):
                out = _act(spec, state)  # deterministic, whatever `train`
                _rec.append((_name, out))
                return out

            pol.act = recorded
            pol.train_round = lambda batch, _rec=batches[key], _name=name: (
                _rec.append((_name, batch)), [])[1]

    (jego, jcbv), (ego, cbv) = pols["jax"], pols["torch"]
    ends = {}
    jst, jcr, jloss = jax_run.train_ego_episode(jenv, jego, jcbv, sc["jstate"], sc["jcrit"],
                                                sc["jspec"], 8, _jitted_project(sc["jmap"]))
    st, cr, loss = run.train_ego_episode(env, ego, cbv, state_from_jax(sc["jstate"]),
                                         crit_from_jax(sc["jcrit"]), env.spec, 8, sc["tmap"])
    ends["ego"] = (jst, jcr, st, cr)
    assert jloss == loss == []
    env.tick = tick0
    jst, jcr, _ = jax_run.train_classic_cbv_episode(jenv, jego, jcbv, sc["jstate"],
                                                    sc["jcrit"], sc["jspec"], 8)
    st, cr, _ = run.train_classic_cbv_episode(env, ego, cbv, state_from_jax(sc["jstate"]),
                                              crit_from_jax(sc["jcrit"]), env.spec, 8)
    ends["cbv"] = (jst, jcr, st, cr)

    assert len(acts["torch"]) == len(acts["jax"]) == 2 * 2 * 8
    for (jname, j), (name, t) in zip(acts["jax"], acts["torch"]):
        assert jname == name
        np.testing.assert_allclose(t["ctrl"].numpy(), np.asarray(j["ctrl"]), atol=1e-4,
                                   rtol=1e-4)
        if name == "cbv":
            assert torch.equal(t["mask"], torch.from_numpy(np.asarray(j["mask"])))
    assert acts["torch"][1][1]["mask"].any()
    for jst, jcr, st, cr in ends.values():
        assert_fields_match(jst, st, atol=1e-4, rtol=1e-4)
        assert_fields_match(jcr, cr, atol=1e-4, rtol=1e-4)
    assert [n for n, _ in batches["torch"]] == [n for n, _ in batches["jax"]] == ["ego", "cbv"]
    for (name, jb), (_, tb) in zip(batches["jax"], batches["torch"]):
        assert set(tb) == set(jb) and len(tb["obs"]) == len(jb["obs"]) > 0
        for k in jb:
            _close(tb[k], jb[k], f"{name} batch {k}")
