"""The port's Pluto on legacy per-CBV tokens (the JAX package's default)
against the JAX package's, on the CPU: the features and the eval and train
act steps (the model's forward and a fit step: test_torch_legacy_fit.py,
on the same scene). Same seeded weights (written by the JAX
package's `save_params_npz`, loaded strictly by `load_jax_params`: the
legacy branches read the parameter tree the canonical ones do), the scene
of test_torch_train.py (grid town, S=2, A=6, CBVs on slots 1 and 2), f32
unless stated.

Tolerances:
- features: integers and masks exactly; floats within 1e-4. Positions
  are ~100 m from the CBV, where an f32 ulp is 7.6e-6, and the JAX
  compile contracts the frame rotation into fused multiply-adds, so
  positions differ by up to 2 ulps (1.5e-5 observed) and the orientation
  of a short segment vector, which is the difference of two such
  positions, by up to 2.8e-5 (observed);
- the act steps: masks, slots and chosen candidates exactly, continuous
  outputs 1e-3 (atol and rtol), as test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.models.pluto import PlutoModel as JaxPluto
from rift_tpu.models.pluto import build_cbv_features as jax_build_features
from rift_tpu.models.pluto.policy import pluto_cbv_act as jax_act
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import cbv_slot_assignment as jax_slots
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.utils.params_io import save_params_npz
from rift_tpu_torch.models.pluto import PlutoModel, build_cbv_features, pluto_cbv_act
from rift_tpu_torch.scenario import cbv_slot_assignment
from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params, load_params_npz
from test_torch_pluto import _seeded_params
from test_torch_train import _flat
from torch_parity import (
    map_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
    stepped_scene,
)

S, A, C = 2, 6, 2
DEPTH = 1


def _model(flat, dtype=torch.float32):
    model = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=dtype, device="cpu")
    load_jax_params(model, flat)
    return model


def legacy_scene(tmp_path_factory):
    """The grid-town scene (S=2, A=6, CBVs on slots 1 and 2, a four-tick
    history stepped by the port's env), its legacy features as the JAX
    batch, the seeded depth-1 parameters in both frameworks, the port's
    map, state and spec. Shared with test_torch_legacy_fit.py."""
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
    feats, _ = jax_build_features(jmap, jstate, jax_slots(jstate.is_cbv, C), jspec)
    batch = _flat(feats)
    jmodel = JaxPluto(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=jnp.float32)
    params = _seeded_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch))
    path = str(tmp_path_factory.mktemp("params") / "pluto.npz")
    save_params_npz(params, path)
    flat = flatten_params(load_params_npz(path))
    tmap = map_from_jax(jmap)
    state, spec = state_from_jax(jstate), spec_from_jax(jspec)
    return dict(jmap=jmap, jstate=jstate, jspec=jspec, jmodel=jmodel, params=params,
                batch=batch, flat=flat, tmap=tmap, state=state, spec=spec, model=_model(flat))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The scene of `legacy_scene` with both act steps on it, the JAX
    package's and the port's, eval and train."""
    w = legacy_scene(tmp_path_factory)
    jmodel, params, jmap, jspec, jstate = (w[k] for k in ("jmodel", "params", "jmap", "jspec",
                                                          "jstate"))
    ref_eval = jax_act(jmodel, params, jmap, jspec, jstate, max_cbvs=C)
    # the train act compiled without XLA's fusion pass, as test_torch_train
    # does (about half the compile time, outputs within 2.1e-5)
    act = jax_act.lower(jmodel, params, jmap, jspec, jstate, max_cbvs=C, train=True).compile(
        {"xla_disable_hlo_passes": "fusion"})
    ref_train = act(params, jmap, jspec, jstate)
    got_eval = pluto_cbv_act(w["model"], w["tmap"], w["spec"], w["state"], max_cbvs=C)
    got_train = pluto_cbv_act(w["model"], w["tmap"], w["spec"], w["state"], max_cbvs=C,
                              train=True)
    return dict(w, ref_eval=ref_eval, ref_train=ref_train, got_eval=got_eval,
                got_train=got_train)


def _assert_tree_close(ref, got, atol, rtol=0.0, prefix=""):
    for k, a in ref.items():
        if isinstance(a, dict):
            _assert_tree_close(a, got[k], atol, rtol, f"{prefix}{k}.")
            continue
        a, b = np.asarray(a), got[k].detach().numpy()
        assert a.shape == b.shape, (prefix + k, a.shape, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=prefix + k)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=prefix + k)


def test_legacy_features_match(world):
    """build_cbv_features(canonical=False): the per-CBV history and polygon
    points in the CBV's frame, with the JAX keys; and the JAX parameter
    tree is one tree for both token conventions."""
    slots = cbv_slot_assignment(world["state"].is_cbv, C)
    feats, valid = build_cbv_features(world["tmap"], world["state"], slots, world["spec"])
    ref, _ = jax_build_features(world["jmap"], world["jstate"],
                                jax_slots(world["jstate"].is_cbv, C), world["jspec"])
    assert set(feats["agent"]) == set(ref["agent"]) and set(feats["map"]) == set(ref["map"])
    _assert_tree_close(ref, feats, atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(slots >= 0))
    m = feats["map"]
    assert (~m["valid_mask"].any(-1)).any() and m["valid_mask"].any(-1).any()
    assert m["point_position"].shape == (S, C, 64, 3, 20, 2)
    assert feats["agent"]["position"].shape == (S, C, 32, 21, 2)

    def canonical_batch(*args):
        f, _, shared = jax_build_features(*args, canonical=True)
        f = _flat(f)
        f["shared"] = {**shared, "scen_idx": jnp.repeat(jnp.arange(S), C)}
        return f

    cbatch = jax.eval_shape(canonical_batch, world["jmap"], world["jstate"],
                            jax_slots(world["jstate"].is_cbv, C), world["jspec"])
    canon = jax.eval_shape(world["jmodel"].init, jax.random.PRNGKey(0), cbatch)
    legacy = jax.tree.map(lambda x: x.shape, world["params"])
    assert jax.tree.map(lambda x: x.shape, canon) == legacy


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_legacy_act_matches(world, mode):
    """pluto_cbv_act on legacy tokens (no shared block, no map tokens),
    eval and train: the train branch's GRPO signals and its buffered
    features, the legacy tree."""
    ref, got = world[f"ref_{mode}"], world[f"got_{mode}"]
    assert np.asarray(ref["mask"]).any()
    for k in ("mask", "cbv_slots", "chosen_idx", "adv_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    keys = ["traj"]
    if mode == "train":
        assert np.asarray(ref["adv_valid"]).sum() >= 24
        keys += ["old_logits", "advantage", "rollout_return", "teacher_speed", "teacher_pos",
                 "teacher_traj", "exec_speed"]
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-3, rtol=1e-3,
                                   err_msg=k)
    _assert_tree_close(ref["features"], got["features"], atol=1e-4)
