"""`--mode collect_data` and PlanT's behaviour-cloning fit of the port
against the JAX package, on the CPU:
- one scene's states (40 ticks of the port's env, S=3, A=6) stored by each
  package's CollectBuffer: the same dataset names, shapes, dtypes and
  values in both files, and each package's `load` reads the other's file;
- `plant_bc_dataset` on that file: tokens, targets and labels within 1e-5,
  token types exactly;
- `fit_plant` on a small PlanT (1 layer, dim 128, 2 heads: head dim 64)
  from the JAX package's weights (`save_params_npz` -> `load_jax_params`)
  on the JAX dataset, the same batches: each epoch's loss within 1e-4
  relative; every parameter within the bound two Adam runs from one start
  can drift apart (derived in `_adam_drift_bound`);
- `run.main --mode collect_data` on a small town (2 episodes; the JAX
  reader opens its file), `--resume` returning the path without an
  episode, and the training script's `main` at small dims, whose npz loads
  strictly into the port's PlanTModel and through the JAX
  `load_plant_params` into the JAX model, which gives the same waypoints.
"""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.models.plant import PlanTModel as JaxPlanT
from rift_tpu.models.plant import train as jtrain
from rift_tpu.rl.collect import CollectBuffer as JaxCollectBuffer
from rift_tpu.sim.state import init_sim_state_host as jax_init_host
from rift_tpu.utils.params_io import save_params_npz as jax_save_npz
from rift_tpu_torch import run
from rift_tpu_torch.map import make_straight_town
from rift_tpu_torch.models.plant import PlanTModel
from rift_tpu_torch.models.plant import train as ttrain
from rift_tpu_torch.rl.collect import CollectBuffer
from rift_tpu_torch.scenario import TrafficEnv
from torch_parity import one_torch_thread, to_jax

S, A, TICKS = 3, 6, 40
SMALL = {"dim": 128, "num_layers": 1, "num_heads": 2}  # head dim 64
LR, EPOCHS, BATCH = 1e-3, 3, 4
H5_DTYPES = {"pos": "float32", "heading": "float32", "speed": "float32", "shape": "float32",
             "control": "float32", "rl_action": "float32", "alive": "bool", "is_cbv": "bool",
             "collision": "bool", "ego_route_cursor": "float32", "tick": "int32",
             "static_ego_route": "float32", "static_ego_route_len": "int32"}


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """TICKS states of the port's env (rule ego, every BV driving) in the
    port's buffer and, as JAX containers, in the JAX one; both saved."""
    out = tmp_path_factory.mktemp("collect")
    tmap = make_straight_town(length=600.0, num_lanes=2, device="cpu")
    env = TrafficEnv(tmap, num_scenarios=S, num_agents=A, max_cbvs=2, seed=1, device="cpu")
    state, crit, spec = env.reset()
    tbuf = CollectBuffer(str(out / "port"), "pdm_lite", "rift_pluto")
    jbuf = JaxCollectBuffer(str(out / "jax"), "pdm_lite", "rift_pluto")
    tbuf.set_static({"ego_route": spec.ego_route, "ego_route_len": spec.ego_route_len})
    jbuf.set_static({"ego_route": spec.ego_route.numpy(),
                     "ego_route_len": spec.ego_route_len.numpy().astype(np.int32)})
    template = jax_init_host(S, A)
    for _ in range(TICKS):
        state, crit = env.step(state, crit)
        tbuf.store(state)
        jbuf.store(to_jax(state, template))
    return {"port": tbuf.save(), "jax": jbuf.save(), "bufs": (tbuf, jbuf)}


def test_collect_files_and_dataset_match_jax(collected, tmp_path):
    paths = {k: collected[k] for k in ("port", "jax")}
    for name, path in paths.items():
        with h5py.File(path, "r") as f:
            assert sorted(f.keys()) == sorted(H5_DTYPES), name
            assert f.attrs["num_ticks"] == TICKS
            for k, dt in H5_DTYPES.items():
                assert f[k].dtype == np.dtype(dt), (name, k, f[k].dtype)
                assert f[k].compression == "gzip", (name, k)
    port, jax_file = JaxCollectBuffer.load(paths["port"]), JaxCollectBuffer.load(paths["jax"])
    for k in H5_DTYPES:
        assert port[k].shape == jax_file[k].shape, k
        if port[k].dtype.kind == "f":
            np.testing.assert_allclose(port[k], jax_file[k], atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], jax_file[k], err_msg=k)
    assert port["pos"].shape == (TICKS, S, A, 2) and port["tick"][-1].tolist() == [TICKS] * S
    # each package's reader on the other's file
    for path in paths.values():
        a, b = CollectBuffer.load(path), JaxCollectBuffer.load(path)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # the buffers were emptied by save; an empty save writes no file
    for buf in collected["bufs"]:
        assert buf.frames == []
        buf.out_dir = str(tmp_path)
        assert not os.path.exists(buf.save())

    ref = jtrain.plant_bc_dataset(port)
    got = ttrain.plant_bc_dataset(port, device="cpu")
    n = S * len(range(0, TICKS - 4 * jtrain.WAYPOINT_STRIDE, jtrain.WAYPOINT_STRIDE))
    for name, a, b in zip(("tokens", "target", "light", "labels"), ref, got, strict=True):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.shape[0] == n, name
        np.testing.assert_allclose(b, a, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[0][..., 0].numpy(), np.asarray(ref[0])[..., 0])
    with pytest.raises(ValueError, match="static_ego_route"):
        ttrain.plant_bc_dataset({k: v for k, v in port.items() if not k.startswith("static")},
                                device="cpu")


def _adam_drift_bound(steps, lr, wd, pmax, b1=0.9, b2=0.999):
    """The most two AdamW runs from one start can differ in a parameter
    after `steps` steps: each step moves it by lr * (|m̂| / (sqrt(v̂) + eps)
    + wd |p|), and with m̂ = Σ w_i g_i, v̂ = Σ u_i g_i² (the bias-corrected
    weights of the t gradients so far) Cauchy-Schwarz gives |m̂| / sqrt(v̂)
    <= sqrt(Σ w_i² / u_i), whatever the gradients."""
    total = 0.0
    for t in range(1, steps + 1):
        age = np.arange(t)[::-1]
        w = (1 - b1) * b1 ** age / (1 - b1 ** t)
        u = (1 - b2) * b2 ** age / (1 - b2 ** t)
        total += np.sqrt((w * w / u).sum()) + wd * pmax
    return 2.0 * lr * total


def test_fit_plant_matches_jax(collected, tmp_path):
    data = JaxCollectBuffer.load(collected["jax"])
    dataset = jtrain.plant_bc_dataset(data)
    jmodel = JaxPlanT(**SMALL)
    params = jmodel.init(jax.random.PRNGKey(0), *(x[:2] for x in dataset[:3]))
    npz = str(tmp_path / "plant.npz")
    jax_save_npz(params, npz)
    model = ttrain.load_plant_weights(PlanTModel(**SMALL, device="cpu"), npz)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    jparams, jlosses = jtrain.fit_plant(jmodel, params, dataset, lr=LR, epochs=EPOCHS,
                                        batch_size=BATCH)
    tdata = tuple(torch.from_numpy(np.array(x)) for x in dataset)
    _, losses = ttrain.fit_plant(model, tdata, lr=LR, epochs=EPOCHS, batch_size=BATCH)
    assert len(losses) == EPOCHS and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    steps = EPOCHS * (dataset[0].shape[0] // BATCH)
    pmax = max(p.abs().max().item() for p in before.values())
    bound = _adam_drift_bound(steps, LR, ttrain.ADAMW["weight_decay"], pmax + steps * LR * 2)
    jax_npz = str(tmp_path / "fitted.npz")
    jax_save_npz(jparams, jax_npz)
    fitted = ttrain.load_plant_weights(PlanTModel(**SMALL, device="cpu"), jax_npz)
    ref = dict(fitted.named_parameters())
    moved = 0.0
    for name, p in model.named_parameters():
        assert (p - ref[name]).abs().max().item() <= bound, name
        moved = max(moved, (p - before[name]).abs().max().item())
    assert moved > LR  # the fit moved the weights


def test_cli_collect_data_and_train_script(tmp_path, capsys):
    out = str(tmp_path / "log")
    argv = ["--mode", "collect_data", "--device", "cpu", "--town", "straight",
            "--num_scenario", "2", "--num_agents", "6", "--num_episodes", "2",
            "--max_ticks", "15", "--out_dir", out, "encoder_depth=1", "decoder_depth=1"]
    path = run.main(argv)
    assert path == os.path.join(out, "collect_data", "pdm_lite-rift_pluto-seed0",
                                "pdm_lite_rift_pluto.hdf5")
    text = capsys.readouterr().out
    assert "episode 1: DS=" in text and f"collect_data: wrote {path}" in text
    data = JaxCollectBuffer.load(path)  # the JAX package's reader
    assert sorted(data) == sorted(H5_DTYPES)
    for k, dt in H5_DTYPES.items():
        assert data[k].dtype == np.dtype(dt), k
    assert data["pos"].shape == (30, 2, 6, 2) and data["static_ego_route"].shape[0] == 2
    # both episodes' frames in one stream, the tick starting again at 1
    assert data["tick"][:, 0].tolist() == list(range(1, 16)) * 2
    with h5py.File(path, "r") as f:
        assert f.attrs["num_ticks"] == 30

    assert run.main(argv + ["--resume"]) == path
    text = capsys.readouterr().out
    assert "exists, skipping" in text and "episode" not in text.replace("episodes", "")

    npz = str(tmp_path / "plant.npz")
    small = {"dim": 64, "num_layers": 1, "num_heads": 1}
    losses = ttrain.main([path, "--device", "cpu", "--epochs", "2", "--out", npz,
                          *(f"--{k}={v}" for k, v in small.items())])
    assert len(losses) == 2 and all(np.isfinite(losses))
    model = ttrain.load_plant_weights(PlanTModel(**small, device="cpu"), npz)
    jparams = jtrain.load_plant_params(npz)
    dataset = ttrain.plant_bc_dataset(CollectBuffer.load(path), device="cpu")
    with torch.no_grad():
        want = model(*dataset[:3])["pred_wp"].numpy()
    got = jax.jit(JaxPlanT(**small).apply)(jparams, *(jnp.asarray(x.numpy())
                                                      for x in dataset[:3]))["pred_wp"]
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)
