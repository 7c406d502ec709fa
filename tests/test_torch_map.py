"""rift_tpu_torch's map build and scene reset against rift_tpu's, from the
same seed: the numpy constructors are copies, so integer, bool and numpy-built
float arrays must agree exactly. The map's queries and reference lines
are test_torch_map_queries.py, the entry points' default device
test_torch_map_device.py (files of at most three tests, which the tier-1
run's loadfile scheduler hands out after its long pole)."""

import dataclasses

import pytest

from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu_torch.map import make_grid_town
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
