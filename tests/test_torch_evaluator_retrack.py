"""The GRPO evaluator's candidate re-tracking against the JAX package, on
the same numpy-seeded inputs, in f32 on the CPU (where the retrack
wrapper runs its plain version).

Tolerances: rollout_candidates and the tie cases 2e-3 against the Pallas
kernel in interpret mode and against the lax.scan (test_evaluator.py's
bound: the Pallas kernel's Taylor atan and re-found closest points move a
path by millimetres); the scan is compared over a 12-frame horizon, whose
compile takes seconds where the 40-frame one takes a minute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ops.retrack import retrack_rollout_pallas
from rift_tpu.rl import evaluator as jev
from rift_tpu_torch.ops.retrack import retrack_rollout_ref
from rift_tpu_torch.rl import evaluator as tev
from torch_parity import one_torch_thread

T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def _retrack_case():
    """test_evaluator.py:152's case."""
    rng = np.random.default_rng(3)
    G, Tn = 7, jev.NUM_FRAMES
    t = np.arange(Tn, dtype=np.float32)
    paths = []
    for _ in range(G):
        v = rng.uniform(0.3, 1.5)
        curve = rng.uniform(-0.02, 0.02)
        x = t * v
        paths.append(np.stack([x, curve * x**2 / 10.0], axis=-1))
    ref_pos = np.stack(paths).astype(np.float32)
    ref_heading = np.arctan2(
        np.gradient(ref_pos[..., 1], axis=1), np.gradient(ref_pos[..., 0], axis=1) + 1e-9
    ).astype(np.float32)
    v0 = rng.uniform(0.0, 12.0, G).astype(np.float32)
    return ref_pos, ref_heading, v0


def test_rollout_candidates_matches_jax():
    ref_pos, ref_heading, v0 = _retrack_case()
    got = tev.rollout_candidates(T(ref_pos), T(ref_heading), T(v0))
    ref = retrack_rollout_pallas(*map(jnp.asarray, (ref_pos, ref_heading, v0)), jev.NUM_FRAMES,
                                 interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3)
    n = 12
    short = (ref_pos[:, :n], ref_heading[:, :n])
    got = tev.rollout_candidates(*map(T, short), T(v0), num_frames=n)
    ref = jev.rollout_candidates(*map(jnp.asarray, short), jnp.asarray(v0), num_frames=n)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3)


def _retrack_tie_case(Tn):
    """Candidates whose closest-point search meets exact ties, the cases
    the kernel's split search must resolve as the serial one does: paths
    that stand still (every point the same, so every distance is equal and
    the first index wins), from rest and from a start speed, and paths
    that double back on themselves (out and back over the same points, so
    each outbound point ties with its return twin)."""
    rng = np.random.default_rng(8)
    G = 8
    t = np.arange(Tn, dtype=np.float32)
    ref_pos = np.zeros((G, Tn, 2), np.float32)
    ref_pos[:4] = rng.uniform(-50, 50, (4, 1, 2))
    s = np.minimum(t, Tn - 1 - t)  # 0, 1, ..., 1, 0: the same floats out and back
    for g in range(4, G):
        yaw = rng.uniform(-np.pi, np.pi)
        step = rng.uniform(0.3, 1.5) * np.array([np.cos(yaw), np.sin(yaw)], np.float32)
        ref_pos[g] = rng.uniform(-50, 50, 2) + s[:, None] * step
    ref_heading = np.repeat(rng.uniform(-np.pi, np.pi, (G, 1)), Tn, 1).astype(np.float32)
    v0 = np.array([0.0, 0.5, 3.0, 8.0, 0.0, 2.0, 5.0, 10.0], np.float32)
    return ref_pos, ref_heading, v0


@pytest.mark.parametrize("Tn", [12, jev.NUM_FRAMES])
def test_retrack_ties_match_jax(Tn):
    """The plain re-tracking on standing-still and doubled-back candidates
    against the Pallas kernel in interpret mode and, over the 12-frame
    horizon, the lax.scan, at test_evaluator.py's 2e-3."""
    ref_pos, ref_heading, v0 = _retrack_tie_case(Tn)
    got = retrack_rollout_ref(T(ref_pos), T(ref_heading[:, 0]), T(v0))
    refs = [retrack_rollout_pallas(*map(jnp.asarray, (ref_pos, ref_heading, v0)), Tn,
                                   interpret=True)]
    if Tn == 12:
        refs.append(jev.rollout_candidates(*map(jnp.asarray, (ref_pos, ref_heading, v0)),
                                           num_frames=Tn))
    for ref in refs:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3)
    # the standing-still candidate from rest never moves
    np.testing.assert_array_equal(got[0][0].numpy(), np.broadcast_to(ref_pos[0, :1], (Tn, 2)))
    assert (got[2][0] == 0).all()
