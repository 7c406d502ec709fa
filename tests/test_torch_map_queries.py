"""The port's map queries and reference lines against rift_tpu's, on
test_torch_map.py's towns and scenes: lane indices and bools exactly,
reference lines (built on the device) within 1e-4 m, the f32 rounding of
cumulative lane arclengths."""

import jax.numpy as jnp
import numpy as np
import torch

from rift_tpu.map.reference_lines import (
    reference_lines_from_chains as jax_reference_lines,
)
from rift_tpu_torch.map import reference_lines_from_chains
from test_torch_map import maps, scenes  # noqa: F401
from torch_parity import assert_same, one_torch_thread  # noqa: F401


def test_query_proximal_matches(maps):  # noqa: F811
    jmap, tmap = maps
    pts = np.random.default_rng(0).uniform(-20.0, 140.0, (64, 2)).astype(np.float32)
    for i, p in enumerate(pts):
        jidx, jin = jmap.query_proximal(jnp.asarray(p), 40.0, 16)
        idx, inn = tmap.query_proximal(torch.from_numpy(p), 40.0, 16)
        assert_same(jin, inn, f"within {i}")
        assert_same(jidx, idx, f"lane_idx {i}")


def test_nearest_lane_matches(maps):  # noqa: F811
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


def test_reference_lines_match(maps, scenes):  # noqa: F811
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
