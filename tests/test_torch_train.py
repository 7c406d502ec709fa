"""The port's GRPO fine-tune round against the JAX package: the train-mode
act step and the per-sample model branches (one train step, the ring
buffer and fit: test_torch_train_step.py, on this file's scene; the RIFT
loss and the kernel wrappers' gradients: test_torch_train_grads.py). Same
seeded weights (written by the JAX package's `save_params_npz`, loaded
strictly by `load_jax_params`), the same scene, f32, on the CPU.

Tolerances:
- train act step: continuous outputs 1e-3 (atol and rtol; ~30 chained
  layers, then a 40-step closed-loop re-tracking), masks, slots and
  indices exactly; the per-sample feature gathers 1e-5;
- the per-sample forward against the JAX shared-token forward 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.models.pluto import PlutoModel as JaxPluto
from rift_tpu.models.pluto import build_cbv_features as jax_build_features
from rift_tpu.models.pluto.policy import canonical_map_tokens as jax_map_tokens
from rift_tpu.models.pluto.policy import pluto_cbv_act as jax_act
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import cbv_slot_assignment as jax_slots
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.utils.params_io import save_params_npz
from rift_tpu_torch.models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params, load_params_npz
from test_torch_pluto import _seeded_params
from torch_parity import (
    map_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
    stepped_scene,
)

S, A, C = 2, 6, 2
DEPTH = 1


def _flat(tree, lead=2):
    """[S, C, ...] leaves -> [S*C, ...] (jax arrays or tensors)."""
    if isinstance(tree, dict):
        return {k: _flat(v, lead) for k, v in tree.items()}
    return tree.reshape((-1,) + tuple(tree.shape[lead:]))


def train_scene(tmp_path_factory):
    """The grid-town scene of test_torch_pluto.py with CBVs on slots 1 and
    2, and the seeded depth-1 model in both frameworks. Shared with
    test_torch_train_step.py."""
    jmap = jax_grid_town(blocks=1, num_lanes=2)
    env = JaxTrafficEnv(jmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=3)
    jstate, crit, jspec = env.reset()
    # populate history: four steps, by the port's env
    jstate, crit = stepped_scene(jmap, jstate, crit, jspec, 4, C)
    jstate = jax_wake(jstate)
    jstate = jstate.replace(
        is_cbv=jstate.is_cbv.at[:, 1:3].set(jstate.alive[:, 1:3]),
        goal=jstate.goal.at[:, 1:3].set(jstate.pos[:, 1:3] + jnp.array([60.0, 0.0])),
        goal_valid=jstate.goal_valid.at[:, 1:3].set(jstate.alive[:, 1:3]),
    )
    jmodel = JaxPluto(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=jnp.float32)

    def batch(*args):  # the param tree's shapes need no feature to run
        feats, _, shared = jax_build_features(*args, canonical=True)
        flat = _flat(feats)
        flat["shared"] = {**shared, "scen_idx": jnp.repeat(jnp.arange(S), C)}
        return flat

    batch = jax.eval_shape(batch, jmap, jstate, jax_slots(jstate.is_cbv, C), jspec)
    params = _seeded_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch))
    path = str(tmp_path_factory.mktemp("params") / "pluto.npz")
    save_params_npz(params, path)
    flat = flatten_params(load_params_npz(path))
    model = PlutoModel(
        encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32, device="cpu"
    )
    load_jax_params(model, flat)
    tmap = map_from_jax(jmap)  # equal to the port's grid town, bit for bit (test_torch_map)
    state, spec = state_from_jax(jstate), spec_from_jax(jspec)
    got = pluto_cbv_act(
        model, tmap, spec, state, max_cbvs=C, train=True, canonical=True,
        map_tok=canonical_map_tokens(model, tmap),
    )
    return dict(jmap=jmap, jstate=jstate, jspec=jspec, jmodel=jmodel, params=params,
                flat=flat, model=model, got=got, tmap=tmap, state=state, spec=spec)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """`train_scene` with both train-mode act steps on it."""
    w = train_scene(tmp_path_factory)
    jmodel, params, jmap, jspec, jstate = (w[k] for k in ("jmodel", "params", "jmap", "jspec",
                                                          "jstate"))
    # the JAX train act compiled without XLA's fusion pass: it compiles in
    # about half the time, and its outputs stay within 2.1e-5 of the
    # default compile's (discrete outputs identical), far inside the 1e-3
    # the port is held to
    jtok = jax_map_tokens(jmodel, params, jmap)
    act = jax_act.lower(
        jmodel, params, jmap, jspec, jstate, max_cbvs=C, train=True, canonical=True,
        map_tok=jtok,
    ).compile({"xla_disable_hlo_passes": "fusion"})
    return dict(w, ref=act(params, jmap, jspec, jstate, map_tok=jtok))


def test_train_act_matches_jax(world):
    ref, got = world["ref"], world["got"]
    valid = np.asarray(ref["adv_valid"])
    assert valid.sum() >= 24 and np.asarray(ref["mask"]).any()
    for k in ("mask", "cbv_slots", "chosen_idx", "adv_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("traj", "old_logits", "advantage", "rollout_return", "value",
              "teacher_speed", "teacher_pos", "teacher_traj", "exec_speed"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), atol=1e-3, rtol=1e-3, err_msg=k
        )
    assert np.abs(np.asarray(ref["rollout_return"])[valid]).min() > 0
    for g, k in (("agent", "hist_feat"), ("map", "canonical_feat")):
        np.testing.assert_allclose(
            got["features"][g][k].numpy(), np.asarray(ref["features"][g][k]), atol=1e-5
        )


def test_execute_teacher_drives_the_teacher_path(world):
    """The BC pretrain's expert rollouts (policy.py:252-266 in the JAX
    package): the CBV slots carry the JAX teacher's 80 waypoints, every
    other slot stays zero, and `exec_speed` is the JAX teacher path's
    implied speed (mean spacing of its first 10 points / 0.1 s), both
    within the train act's 1e-3; the training signals are those of the
    plain train act."""
    ref, got = world["ref"], world["got"]
    res = pluto_cbv_act(
        world["model"], world["tmap"], world["spec"], world["state"], max_cbvs=C,
        train=True, canonical=True, map_tok=canonical_map_tokens(world["model"], world["tmap"]),
        execute_teacher=True,
    )
    teacher = np.asarray(ref["teacher_traj"])  # [S, C, 80, 2]
    slots = np.asarray(ref["cbv_slots"])
    want = np.zeros(res["traj"].shape, np.float32)
    for s in range(S):
        for c in range(C):
            if slots[s, c] >= 0:
                want[s, slots[s, c]] = teacher[s, c]
    assert (slots >= 0).sum() == 4 and res["traj"].shape[2] == teacher.shape[2]
    np.testing.assert_allclose(res["traj"].numpy(), want, atol=1e-3, rtol=1e-3)
    assert not res["traj"].numpy()[want == 0].any()
    step = np.linalg.norm(np.diff(teacher[:, :, :10], axis=2), axis=-1)
    np.testing.assert_allclose(res["exec_speed"].numpy(), step.mean(-1) / 0.1,
                               atol=1e-3, rtol=1e-3)
    for k in ("advantage", "teacher_speed", "teacher_traj", "old_logits"):
        torch.testing.assert_close(res[k], got[k], rtol=0, atol=0)
    assert torch.equal(res["mask"], got["mask"])


def test_per_sample_forward_matches_shared_tokens(world):
    """The fit forward (per-sample agent and map branches, no shared
    blocks) gives the logits the act step's shared-token forward gave."""
    feats = _flat(world["got"]["features"])
    with torch.no_grad():
        out = world["model"]({**feats, "no_aux": True})
    np.testing.assert_allclose(
        out["probability"].numpy(),
        np.asarray(world["ref"]["old_logits"]).reshape(S * C, 4, 12), atol=1e-4,
    )
