"""The port's eval `rollout_chunk` against the JAX package's, on the CPU, as
the slice as a whole: K=3 ticks from `test_torch_world.py`'s scene (S=2,
A=10, two CBVs per scenario), the Pluto CBVs planning every tick through
the seeded depth-1 model (written by the JAX package's `save_params_npz`,
loaded by `load_jax_params`), then the env step.

Tolerances: integer and bool fields exactly; float fields 1e-3 (atol and
rtol: ~20 chained layers a tick, as the act-step tests).
"""

import jax
import jax.numpy as jnp
import torch

from rift_tpu.models.pluto import PlutoModel as JaxPluto
from rift_tpu.models.pluto import build_cbv_features as jax_build_features
from rift_tpu.models.pluto.policy import canonical_map_tokens as jax_map_tokens
from rift_tpu.rollout import rollout_chunk as jax_rollout_chunk
from rift_tpu.scenario import cbv_slot_assignment as jax_slots
from rift_tpu.utils.params_io import save_params_npz
from rift_tpu_torch.models.pluto import PlutoModel, canonical_map_tokens
from rift_tpu_torch.rollout import rollout_chunk
from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params, load_params_npz
from test_torch_pluto import _flatten_batch, _seeded_params
from test_torch_world import C, jax_scene
from torch_parity import (
    assert_fields_match,
    crit_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
)


def test_eval_rollout_matches(tmp_path):
    scene = jax_scene()
    jmap, jspec, jstate, jcrit = scene["jmap"], scene["jspec"], scene["jstate"], scene["jcrit"]
    jmodel = JaxPluto(encoder_depth=1, decoder_depth=1, dtype=jnp.float32)
    # the param tree's shapes from shapes alone: no feature or init runs

    def batch(*args):
        feats, _, shared = jax_build_features(*args, canonical=True)
        return _flatten_batch(feats, shared)  # test_torch_pluto's S = C = 2, as here

    batch = jax.eval_shape(batch, jmap, jstate, jax_slots(jstate.is_cbv, C), jspec)
    params = _seeded_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch))
    path = str(tmp_path / "pluto.npz")
    save_params_npz(params, path)
    model = PlutoModel(encoder_depth=1, decoder_depth=1, dtype=torch.float32, device="cpu")
    load_jax_params(model, flatten_params(load_params_npz(path)))

    ref = jax_rollout_chunk(
        jmodel, params, jmap, jspec, jstate, jcrit, max_cbvs=C, num_steps=3, canonical=True,
        map_tok=jax_map_tokens(jmodel, params, jmap),
    )
    got = rollout_chunk(
        model, scene["tmap"], spec_from_jax(jspec), state_from_jax(jstate),
        crit_from_jax(jcrit), max_cbvs=C, num_steps=3, canonical=True,
        map_tok=canonical_map_tokens(model, scene["tmap"]), tick=0,
    )
    assert int(got[0].is_cbv.sum()) > 0 and int(got[1].cbv_count.sum()) > 0
    assert_fields_match(ref[0], got[0], atol=1e-3, rtol=1e-3)
    assert_fields_match(ref[1], got[1], atol=1e-3, rtol=1e-3)
