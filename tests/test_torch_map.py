"""rift_tpu_torch's map build and scene reset against rift_tpu's, from the
same seed: the numpy constructors are copies, so integer, bool and numpy-built
float arrays must agree exactly; device-built float arrays (reference
lines) within 1e-4 m, the f32 rounding of cumulative lane arclengths."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.map.reference_lines import (
    reference_lines_from_chains as jax_reference_lines,
)
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu_torch.map import make_grid_town, reference_lines_from_chains
from rift_tpu_torch.map.tensor_map import TensorMap
from rift_tpu_torch.scenario import TrafficEnv
from rift_tpu_torch.sim.state import ScenarioSpec, SimState
from torch_parity import assert_fields_match, assert_same, one_torch_thread

S, A, C = 2, 6, 2


@pytest.fixture(scope="module")
def maps():
    return jax_grid_town(blocks=1, num_lanes=2), make_grid_town(
        blocks=1, num_lanes=2, device="cpu"
    )


@pytest.fixture(scope="module")
def scenes(maps):
    jmap, tmap = maps
    jstate, jcrit, jspec = JaxTrafficEnv(
        jmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=3
    ).reset()
    state, crit, spec = TrafficEnv(
        tmap, num_scenarios=S, num_agents=A, max_cbvs=C, seed=3, device="cpu"
    ).reset()
    return jstate, jcrit, jspec, state, crit, spec


def test_tensor_map_matches(maps):
    jmap, tmap = maps
    for f in dataclasses.fields(TensorMap):
        assert_same(getattr(jmap, f.name), getattr(tmap, f.name), f.name)


def test_reset_spec_matches(scenes):
    jstate, _, jspec, state, _, spec = scenes
    for f in dataclasses.fields(ScenarioSpec):
        a, b = getattr(jspec, f.name), getattr(spec, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert_same(a, b, f.name)


def test_reset_state_matches(scenes):
    """The spawned state, and the fresh criteria state reset returns."""
    jstate, jcrit, _, state, crit, _ = scenes
    assert_fields_match(jcrit, crit, atol=0.0)
    for f in dataclasses.fields(SimState):
        if f.name == "tracker":
            continue
        assert_same(getattr(jstate, f.name), getattr(state, f.name), f.name)
    for pid in ("speed", "turn"):
        for k in ("buf", "ptr", "count"):
            assert_same(
                getattr(getattr(jstate.tracker, pid), k),
                getattr(getattr(state.tracker, pid), k),
                f"tracker.{pid}.{k}",
            )


def test_query_proximal_matches(maps):
    jmap, tmap = maps
    pts = np.random.default_rng(0).uniform(-20.0, 140.0, (64, 2)).astype(np.float32)
    for i, p in enumerate(pts):
        jidx, jin = jmap.query_proximal(jnp.asarray(p), 40.0, 16)
        idx, inn = tmap.query_proximal(torch.from_numpy(p), 40.0, 16)
        assert_same(jin, inn, f"within {i}")
        assert_same(jidx, idx, f"lane_idx {i}")


def test_nearest_lane_matches(maps):
    jmap, tmap = maps
    r = np.random.default_rng(1)
    pts = r.uniform(-20.0, 140.0, (256, 2)).astype(np.float32)
    hdg = r.uniform(-np.pi, np.pi, 256).astype(np.float32)
    tp, th = torch.from_numpy(pts), torch.from_numpy(hdg)
    assert_same(jmap.nearest_lane(jnp.asarray(pts)), tmap.nearest_lane(tp), "grid")
    assert_same(
        jmap.nearest_lane(jnp.asarray(pts), jnp.asarray(hdg)),
        tmap.nearest_lane(tp, th), "grid+heading",
    )
    assert_same(jmap.nearest_lane_full(jnp.asarray(pts)), tmap.nearest_lane_full(tp), "full")


def test_reference_lines_match(maps, scenes):
    jmap, tmap = maps
    jstate, _, jspec, state, _, spec = scenes
    alive = np.argwhere(np.asarray(jstate.alive))
    scen = torch.from_numpy(alive[:, 0])
    slot = torch.from_numpy(alive[:, 1])
    got = reference_lines_from_chains(
        tmap, spec.lane_chains, scen, state.lane[scen, slot], state.pos[scen, slot]
    )
    for b, (s, a) in enumerate(alive):
        ref = jax_reference_lines(
            jmap, jspec.lane_chains[s], jstate.lane[s, a], jstate.pos[s, a]
        )
        assert_same(ref["valid_mask"], got["valid_mask"][b], "valid_mask")
        for k in ("position", "vector", "orientation"):
            np.testing.assert_allclose(
                np.asarray(ref[k]), got[k][b].numpy(), atol=1e-4, err_msg=k
            )


def test_entry_points_default_to_cuda():
    """Without device="cpu" the port runs on CUDA, and raises where there
    is no card instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_grid_town(blocks=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrafficEnv(make_grid_town(blocks=1, device="cpu"), num_scenarios=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from rift_tpu_torch.models.pluto import PlutoModel

        PlutoModel(encoder_depth=1, decoder_depth=1)
