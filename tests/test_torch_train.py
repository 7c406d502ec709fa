"""The port's GRPO fine-tune round against the JAX package: the train-mode
act step, the per-sample model branches, the RIFT loss, one train step,
the ring buffer, fit, and the gradients of the two PR-1 kernel wrappers.
Same seeded weights (written by the JAX package's `save_params_npz`,
loaded strictly by `load_jax_params`), the same scene, f32, on the CPU.

Tolerances:
- train act step: continuous outputs 1e-3 (atol and rtol; ~30 chained
  layers, then a 40-step closed-loop re-tracking), masks, slots and
  indices exactly; the per-sample feature gathers 1e-5;
- the per-sample forward against the JAX shared-token forward 1e-4;
- rift_loss 1e-6 (a handful of f32 exp/log per element);
- one train step: loss and the updated pi_head within 1e-5, every other
  parameter unchanged (bit-identical). The loss is invariant to a uniform
  shift of all logits, so some pi_head gradients (its output bias, the
  layer-norm bias of units active for every candidate) are float noise,
  which Adam's first step g / (|g| + 1e-8) turns into a step of up to lr
  in either direction: elements whose gradient is below 1e-6 are held to
  that bound (|step| <= lr), all others within 1e-5;
- ring_append exactly;
- wrapper gradients against jax.grad of the XLA versions: attention
  1e-5, PointNet 1e-4 with rtol 1e-4 (a 512-deep product chain).
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
from rift_tpu.ops.attention import fused_attention_xla
from rift_tpu.ops.points import points_forward_xla
from rift_tpu.rl import buffer as jbuf
from rift_tpu.rl.losses import rift_loss as jax_rift_loss
from rift_tpu.rl.trainer import TrainConfig as JaxTrainConfig
from rift_tpu.rl.trainer import make_optimizer as jax_make_optimizer
from rift_tpu.rl.trainer import make_train_step as jax_make_train_step
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.scenario import cbv_slot_assignment as jax_slots
from rift_tpu.scenario import wake_all_bvs as jax_wake
from rift_tpu.utils.params_io import save_params_npz
from rift_tpu_torch.models.pluto import PlutoModel, canonical_map_tokens, pluto_cbv_act
from rift_tpu_torch.ops.attention import fused_attention
from rift_tpu_torch.ops.points import points_encoder
from rift_tpu_torch.rl import (
    TrainConfig,
    fit,
    gather_batch,
    make_optimizer,
    rift_loss,
    rift_loss_fn,
    ring_append,
    ring_init,
    ring_reset,
    sample_batches,
    train_step,
)
from rift_tpu_torch.rl.trainer import lr_schedule
from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params, load_params_npz
from test_torch_pluto import _seeded_params, _to_torch
from torch_parity import (
    attn_inputs,
    map_from_jax,
    one_torch_thread,
    points_weights,
    spec_from_jax,
    state_from_jax,
    stepped_scene,
)

S, A, C = 2, 6, 2
DEPTH = 1
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def _flat(tree, lead=2):
    """[S, C, ...] leaves -> [S*C, ...] (jax arrays or tensors)."""
    if isinstance(tree, dict):
        return {k: _flat(v, lead) for k, v in tree.items()}
    return tree.reshape((-1,) + tuple(tree.shape[lead:]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The grid-town scene of test_torch_pluto.py with CBVs on slots 1 and
    2, the seeded depth-1 model in both frameworks, and both train-mode act
    steps on it."""
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

    # the JAX train act compiled without XLA's fusion pass: it compiles in
    # about half the time, and its outputs stay within 2.1e-5 of the
    # default compile's (discrete outputs identical), far inside the 1e-3
    # the port is held to
    jtok = jax_map_tokens(jmodel, params, jmap)
    act = jax_act.lower(
        jmodel, params, jmap, jspec, jstate, max_cbvs=C, train=True, canonical=True,
        map_tok=jtok,
    ).compile({"xla_disable_hlo_passes": "fusion"})
    ref = act(params, jmap, jspec, jstate, map_tok=jtok)
    got = pluto_cbv_act(
        model, tmap, spec, state, max_cbvs=C, train=True, canonical=True,
        map_tok=canonical_map_tokens(model, tmap),
    )
    return dict(jmodel=jmodel, params=params, flat=flat, model=model, ref=ref, got=got,
                tmap=tmap, state=state, spec=spec)


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


def test_rift_loss_matches_jax():
    r = np.random.default_rng(4)
    bs, R, M = 5, 4, 12
    prob = r.normal(0, 2, (bs, R, M)).astype(np.float32)
    old = (prob + r.normal(0, 0.3, prob.shape)).astype(np.float32)
    adv = r.normal(0, 1, (bs, R, M)).astype(np.float32)
    pad = r.random((bs, R)) < 0.3
    valid = (r.random((bs, R, M)) < 0.8) & ~pad[..., None]
    args = (prob, pad, old, adv, valid)
    ref = float(jax_rift_loss(*map(jnp.asarray, args)))
    np.testing.assert_allclose(float(rift_loss(*map(T, args))), ref, atol=1e-6)


def test_train_step_matches_jax(world):
    """One step from identical params and batch (the act step's samples)
    against make_train_step(loss, *make_optimizer(...)) at the same lr."""
    ref = world["ref"]
    jbatch = {
        "features": _flat(ref["features"]),
        "old_logits": _flat(ref["old_logits"]),
        "advantage": _flat(ref["advantage"]),
        "valid": _flat(ref["adv_valid"]),
    }
    jmodel, params = world["jmodel"], world["params"]

    def loss_fn(p, b, rng):
        out = jmodel.apply(p, b["features"])
        r_pad = ~b["features"]["reference_line"]["valid_mask"].any(-1)
        return jax_rift_loss(out["probability"], r_pad, b["old_logits"], b["advantage"],
                             b["valid"])

    lr = 1e-4
    tx, mask = jax_make_optimizer(params, JaxTrainConfig())
    step = jax_make_train_step(loss_fn, tx, mask)
    new_params, _, jloss = step(params, tx.init(params), jbatch, jax.random.PRNGKey(0), lr)
    new_flat = flatten_params(jax.tree.map(np.asarray, new_params))

    model = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32,
                       device="cpu")
    load_jax_params(model, world["flat"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model, TrainConfig())
    loss = train_step(model, opt, rift_loss_fn, _to_torch(jbatch), lr, TrainConfig())
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    want = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32,
                      device="cpu")
    load_jax_params(want, new_flat)
    want = dict(want.named_parameters())
    held = 0
    for name, p in model.named_parameters():
        if not name.startswith("planning_decoder.pi_head"):
            assert torch.equal(p.detach(), before[name]), name
            continue
        # a gradient at the float-noise floor turns into Adam's first step
        # g / (|g| + 1e-8) in either framework: those elements agree only
        # in bound; every other one within 1e-5
        sig = (p.grad.abs() > 1e-6).numpy()
        got, ref = p.detach().numpy(), want[name].detach().numpy()
        np.testing.assert_allclose(got[sig], ref[sig], atol=1e-5, err_msg=name)
        step = np.abs(np.stack([got, ref]) - before[name].numpy())
        assert step.max() <= 1.01 * lr, name
        held += int(sig.sum())
        if sig.any():
            assert np.abs(got - before[name].numpy())[sig].min() > 0.5 * lr, name
    assert held > 16000  # nearly all of pi_head's 16.8k parameters


def test_ring_append_matches_jax():
    """Drop-invalid, wrap-around slots: capacity 5, appends of 3 (1
    invalid), 4 (wraps) and 2 (all invalid)."""
    r = np.random.default_rng(6)
    spec = {"x": np.zeros((2,), np.float32), "n": {"k": np.zeros((), np.int32)}}
    jb = jbuf.ring_init(jax.tree.map(jnp.asarray, spec), capacity=5)
    tb = ring_init(_to_torch(spec), capacity=5)
    for n, valid in ((3, [True, False, True]), (4, [True] * 4), (2, [False, False])):
        samples = {"x": r.normal(size=(n, 2)).astype(np.float32),
                   "n": {"k": r.integers(0, 100, n).astype(np.int32)}}
        jb = jbuf.ring_append(jb, jax.tree.map(jnp.asarray, samples), jnp.asarray(valid))
        tb = ring_append(tb, _to_torch(samples), torch.tensor(valid))
        assert (tb.size, tb.ptr) == (int(jb.size), int(jb.ptr))
        np.testing.assert_array_equal(tb.data["x"].numpy(), np.asarray(jb.data["x"]))
        np.testing.assert_array_equal(tb.data["n"]["k"].numpy(), np.asarray(jb.data["n"]["k"]))
    assert tb.full and (tb.size, tb.ptr) == (5, 1)
    gen = torch.Generator().manual_seed(0)
    idx = sample_batches(tb, gen, 2, 2)  # a permutation: 4 of the 5
    assert idx.shape == (2, 2) and len(set(idx.flatten().tolist())) == 4
    assert gather_batch(tb, idx[0])["x"].shape == (2, 2)
    assert sample_batches(tb, gen, 4, 2).max() < 5  # 8 > 5: with replacement
    assert ring_reset(tb).size == 0


def test_fit_moves_only_pi_head(world):
    """fit over a full buffer of the act step's samples: finite losses,
    pi_head moved, everything else bit-identical; the lr follows the
    warmup-cosine schedule with the per-round decay; an empty buffer
    raises."""
    got = world["got"]
    samples = {
        "features": _flat(got["features"]),
        "old_logits": _flat(got["old_logits"]),
        "advantage": _flat(got["advantage"]),
        "valid": _flat(got["adv_valid"]),
    }
    first = lambda t: {k: first(v) for k, v in t.items()} if isinstance(t, dict) else t[0]
    buf = ring_init(first(samples), capacity=4)
    ring_append(buf, samples, _flat(got["cbv_slots"] >= 0, lead=2).reshape(-1))
    assert buf.full
    model = PlutoModel(encoder_depth=DEPTH, decoder_depth=DEPTH, dtype=torch.float32,
                       device="cpu")
    load_jax_params(model, world["flat"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    cfg = TrainConfig(epochs=2, warmup_epochs=1, batch_size=2)
    losses = fit(model, buf, rift_loss_fn, cfg, torch.Generator().manual_seed(0))
    assert len(losses) == 2 and np.isfinite(losses).all()
    moved = 0.0
    for n, p in model.named_parameters():
        assert p.requires_grad
        if n.startswith("planning_decoder.pi_head"):
            moved += float((p.detach() - before[n]).abs().sum())
        else:
            assert torch.equal(p.detach(), before[n]), n
    assert moved > 0.0
    sched = lr_schedule(TrainConfig(epochs=2, warmup_epochs=1), 2, round_idx=1)
    lr0 = 1e-4 * 0.9
    np.testing.assert_allclose(
        [sched(i) for i in range(4)], [0.0, lr0 / 2, lr0, (lr0 + 0.9 * lr0) / 2], rtol=1e-12
    )
    with pytest.raises(ValueError, match="empty"):
        fit(model, ring_reset(buf), rift_loss_fn, cfg, torch.Generator())


def test_attention_gradient_matches_jax():
    B, Tq, Tk, D, H = 3, 5, 7, 64, 4
    q, k, v, bias, kpad = attn_inputs(B, Tq, Tk, D, H, seed=2)
    kpad[0] = 0.0  # keep every row's keys reachable
    w = np.random.default_rng(3).normal(0, 1, (B, Tq, D)).astype(np.float32)
    loss = lambda *a: jnp.sum(fused_attention_xla(*a, H) * w)
    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias, kpad)))
    xs = [T(x).requires_grad_(True) for x in (q, k, v, bias)]
    out = fused_attention(*xs, T(kpad), H)
    assert out.grad_fn is not None
    (out * T(w)).sum().backward()
    for x, r in zip(xs, ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), atol=1e-5)


def test_points_gradient_matches_jax():
    r = np.random.default_rng(8)
    x = r.normal(0, 2.0, (6, 20, 10)).astype(np.float32)
    mask = r.random((6, 20)) < 0.7
    mask[2] = False
    wts = points_weights(9, 10, 64)
    g = r.normal(0, 1, (6, 64)).astype(np.float32)
    loss = lambda xx, ww: jnp.sum(points_forward_xla(xx, jnp.asarray(mask), ww, True) * g)
    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), tuple(map(jnp.asarray, wts)))
    tx = T(x).requires_grad_(True)
    tw = [T(a).requires_grad_(True) for a in wts]
    out = points_encoder(tx, T(mask), tw, 64)
    assert out.grad_fn is not None
    (out * T(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), atol=1e-4, rtol=1e-4)
    for a, b in zip(tw, dw):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
