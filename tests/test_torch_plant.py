"""The port's PlanT tokens, waypoints, attention scores and attention
recognition against the JAX package's, on the CPU.

The JAX model's params are initialised from a PRNG key, saved with the
JAX package's `save_params_npz` and loaded strictly into the port's model
(`load_plant_weights`: every key used, every shape matching), so both run
the same weights. Checked: `build_plant_tokens` on a scene of 24 agents
(more than the 16 vehicle tokens) with an exact distance tie at the cut;
`plant_ego_waypoints` and `plant_attn_scores` on that scene; and
`attn_recognize_cbvs`'s ranking with tied and -inf scores, over given rule
candidates. The model alone, and the port's imports, are
test_torch_plant_model.py.

Tolerances: the waypoints and scores 1e-5 (atol and rtol; f32 products
summed in another order; the GRU's four steps), tokens 1e-5 (the frame
rotation by another library's sin and cos), the vehicle slots and the
ranks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map import make_straight_town as jax_straight_town
from rift_tpu.models.plant import PlanTModel as JaxPlanT
from rift_tpu.models.plant import build_plant_tokens as jax_tokens
from rift_tpu.models.plant import plant_ego_waypoints as jax_waypoints
from rift_tpu.models.plant.train import plant_attn_scores as jax_attn_scores
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import recognition as jax_recognition
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.utils.params_io import save_params_npz as jax_save_params
from rift_tpu_torch.models.plant import PlanTModel, build_plant_tokens, plant_ego_waypoints
from rift_tpu_torch.models.plant.train import load_plant_weights, plant_attn_scores
from rift_tpu_torch.scenario import recognition
from rift_tpu_torch.utils.params_io import jax_flat_params
from torch_parity import map_from_jax, one_torch_thread, spec_from_jax, state_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
S, A = 3, 24


def model_pair(tmp_path, dim, num_layers, num_heads, forecast_heads=False, seed=0):
    """The JAX model and params, and the port's model loaded from their npz."""
    jm = JaxPlanT(dim=dim, num_layers=num_layers, num_heads=num_heads,
                  forecast_heads=forecast_heads)
    O = 18
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, O, 7)),
                              jnp.zeros((1, 2)), jnp.zeros((1, 1)))
    path = str(tmp_path / f"plant_{dim}_{seed}.npz")
    jax_save_params(params, path)
    tm = PlanTModel(dim=dim, num_layers=num_layers, num_heads=num_heads,
                    forecast_heads=forecast_heads, device="cpu")
    load_plant_weights(tm, path)
    with np.load(path) as saved:
        flat = jax_flat_params(tm)
        assert sorted(flat) == sorted(saved.files)
        for key in saved.files:
            np.testing.assert_array_equal(flat[key], saved[key], err_msg=key)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def scene():
    """A seeded JAX reset of a straight town (S=3, A=24, every pooled BV
    awake, every slot of scenario 0 alive, slot 2 of scenario 1 dead),
    scenario 0's ego moved to (200,
    5.25), its other vehicles to distinct distances along the road and its
    slots 4 and 9 to the same distance ahead and behind it, between the
    15th and the 16th nearest of the others: the last vehicle
    token is a tie, which the lower slot takes."""
    jmap = jax_straight_town(length=300.0, num_lanes=2)
    env = JaxTrafficEnv(jmap, num_scenarios=S, num_agents=A, max_cbvs=3, seed=3)
    jstate, _, jspec = env.reset()
    jstate = jax_wake(jstate)
    pos, alive = np.array(jstate.pos), np.array(jstate.alive)
    ego = np.array([200.0, 5.25], np.float32)
    pos[0, 0] = ego
    alive[0] = True  # tokens read positions only: 23 vehicles at given places
    alive[1, 2] = False
    others = [j for j in range(1, A) if j not in (4, 9)]
    pos[0, others] = ego + np.stack([3.7 * np.arange(len(others)) + 1.3,
                                     np.full(len(others), 3.0)], axis=-1)
    d = np.sort(np.linalg.norm(pos[0, others] - ego, axis=-1))
    r = np.float32(np.round(32.0 * (d[14] + d[15])) / 64.0)  # exact in f32 at 200 m
    assert d[14] < r < d[15]
    pos[0, 4], pos[0, 9] = ego + (r, 0.0), ego - (r, 0.0)
    jstate = jstate.replace(pos=jnp.asarray(pos), alive=jnp.asarray(alive))
    return jmap, jspec, jstate


def test_plant_tokens_match_jax(scene):
    """Tokens, target point, light flag and the vehicle slots behind the
    tokens; scenario 0's 16th nearest is a distance tie between slots 4
    and 9, which jax.lax.top_k breaks to the lower slot: 4 is a token, 9
    is not."""
    _, jspec, jstate = scene
    spec, state = spec_from_jax(jspec), state_from_jax(jstate)
    ref = jax.jit(jax_tokens, static_argnames="return_vehicle_index")(
        jspec, jstate, return_vehicle_index=True)
    got = build_plant_tokens(spec, state, return_vehicle_index=True)
    for name, r, g in zip(("tokens", "target", "light"), ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    d = np.linalg.norm(np.asarray(jstate.pos[0]) - np.asarray(jstate.pos[0, 0]), axis=-1)
    slots = got[3].numpy()
    assert d[4] == d[9] and slots[0, 15] == 4 and 9 not in slots[0]
    assert 2 not in slots[1]


def test_plant_waypoints_and_scores_match_jax(tmp_path, scene):
    """plant_ego_waypoints (the densified tracker path) and
    plant_attn_scores (the CLS attention scattered to agent slots, -inf
    elsewhere) with one set of weights at head dim 64."""
    _, jspec, jstate = scene
    jm, params, tm = model_pair(tmp_path, 128, 2, 2, seed=1)
    spec, state = spec_from_jax(jspec), state_from_jax(jstate)
    np.testing.assert_allclose(plant_ego_waypoints(tm, spec, state).numpy(),
                               np.asarray(jax_waypoints(jm, params, jspec, jstate)), **TOL)
    ref = np.asarray(jax.jit(jax_attn_scores, static_argnums=0)(jm, params, jspec, jstate))
    got = plant_attn_scores(tm, spec, state).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], **TOL)


def test_attention_recognition_ranks_ties_and_inf(monkeypatch, scene):
    """attn_recognize_cbvs over given rule candidates: scenario 0 has two
    free slots and four candidates, two tied at the top; scenario 1 one
    free slot, its best candidate at -inf (no vehicle token), the next
    two tied; scenario 2 no free slot. Promotions, goals and interaction
    indices equal the JAX package's."""
    jmap, jspec, jstate = scene
    r = np.random.default_rng(4)
    cur = np.zeros((S, A), bool)
    cur[0, 1] = True
    cur[1, [3, 4]] = True
    cur[2, 1:4] = True
    cand = np.zeros((S, A), bool)
    cand[0, [2, 5, 7, 11]] = True
    cand[1, [6, 8, 10]] = True
    cand[2, [5, 6]] = True
    scores = r.normal(size=(S, A)).astype(np.float32)
    scores[0, [5, 11]] = 3.0  # tied at the top
    scores[1, 6] = -np.inf
    scores[1, [8, 10]] = 1.5
    goal = r.normal(0, 50, (S, A, 2)).astype(np.float32)
    inter = r.integers(0, 80, (S, A)).astype(np.int32)
    rule = lambda lib: lambda *a, **k: (
        lib.asarray(cur | cand), lib.asarray(goal), lib.asarray(cand), lib.asarray(inter),
        lib.asarray(cand))
    monkeypatch.setattr(jax_recognition, "recognize_cbvs", rule(jnp))
    monkeypatch.setattr(recognition, "recognize_cbvs", rule(torch))
    jstate = jstate.replace(is_cbv=jnp.asarray(cur))
    ref = jax_recognition.attn_recognize_cbvs(
        jmap, jspec, jstate, lambda _s: jnp.asarray(scores), max_cbvs=3)
    got = recognition.attn_recognize_cbvs(
        map_from_jax(jmap), spec_from_jax(jspec), state_from_jax(jstate),
        lambda _s: torch.from_numpy(scores), max_cbvs=3)
    for name, a, b in zip(("is_cbv", "goal", "goal_valid", "interaction", "promote"), ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    promote = got[4].numpy()
    assert sorted(np.flatnonzero(promote[0])) == [5, 11]
    assert sorted(np.flatnonzero(promote[1])) == [8] and not promote[2].any()
