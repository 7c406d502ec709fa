"""The E2E camera egos end to end against the JAX package, on the CPU: the
semantic cameras, a short closed loop with an E2E ego, the behaviour-
cloning fit step by step, and a `train_ego` CLI run whose npz the JAX
package's ego reads.

The scene is a JAX reset of the small grid town (S=2, A=8, a walker and
a static each) with one scenario's visibility cut by weather; later ticks
come from the port's env (torch_parity's converters), and every JAX
program is jitted once in the module fixture.

Tolerances: each 0/1 camera channel differs on at most 0.1% of its pixels
(a ground point on a raster cell's, a box's or the route band's edge may
fall either side), inverse depth, the static ground table and the
projections within 1e-6; the E2E waypoints within 1e-4 (the model's,
test_torch_e2e_model.py); the fit's first two losses within 1e-4
relative (optax's Adam and torch's AdamW, the same arithmetic rounded
apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rift_tpu.ego import sensors as jsensors
from rift_tpu.map import make_grid_town as jax_grid_town
from rift_tpu.models.e2e import E2EModel as JaxE2E
from rift_tpu.models.e2e import policy as jpolicy
from rift_tpu.models.e2e import train as jax_train
from rift_tpu.models.e2e.train import bc_loss as jax_bc_loss
from rift_tpu.policies import EGO_POLICY_LIST as JAX_EGOS
from rift_tpu.scenario import TrafficEnv as JaxTrafficEnv
from rift_tpu.utils.params_io import save_params_npz as jax_save_params
from rift_tpu_torch import run
from rift_tpu_torch.ego import sensors
from rift_tpu_torch.models.e2e import E2EModel, e2e_ego_waypoints, e2e_inputs
from rift_tpu_torch.models.e2e.model import bev_cell_centers
from rift_tpu_torch.models.e2e.train import bc_dataset, bc_fit, bc_rollout
from rift_tpu_torch.policies import EGO_POLICY_LIST
from rift_tpu_torch.rollout import rollout_chunk
from rift_tpu_torch.scenario import TrafficEnv
from rift_tpu_torch.utils.params_io import flatten_params, load_jax_params, load_params_npz
from rift_tpu_torch.utils.params_io import save_params_npz
from torch_parity import (
    assert_fields_match,
    crit_from_jax,
    map_from_jax,
    one_torch_thread,
    spec_from_jax,
    state_from_jax,
    to_jax,
)

S, A = 2, 8
WP_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    """The JAX scene and its port twin, and the jitted JAX programs: the
    cameras and the E2E waypoints (params as an argument) of a variant,
    and VAD's init and BC step."""
    jsensors._rays()  # the module's ray cache, made outside any trace
    jmap = jax_grid_town(blocks=1, num_lanes=2)
    env = JaxTrafficEnv(jmap, num_scenarios=S, num_agents=A, seed=3, num_walkers=1,
                        num_statics=1)
    jstate, jcrit, jspec = env.reset()
    jspec = jspec.replace(visibility=jnp.asarray([1.0, 0.45], jnp.float32))
    tmap = map_from_jax(jmap)
    spec = spec_from_jax(jspec)
    tenv = TrafficEnv(tmap, num_scenarios=S, num_agents=A, device="cpu")
    tenv.spec = spec
    vad = JaxE2E(variant="vad")
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(3e-4))

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(lambda p: jax_bc_loss(vad, p, batch))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return {
        "jmap": jmap, "jspec": jspec, "jstate": jstate, "jcrit": jcrit,
        "tmap": tmap, "spec": spec, "state": state_from_jax(jstate),
        "crit": crit_from_jax(jcrit), "env": tenv,
        "render": jax.jit(lambda sp, st: jsensors.render_cameras(jmap, sp, st)),
        "inputs": jax.jit(lambda sp, st: jpolicy.e2e_inputs(sp, st, jmap)),
        "waypoints": {v: jax.jit(lambda p, sp, st, m=JaxE2E(variant=v):
                                 jpolicy.e2e_ego_waypoints(m, p, jmap, sp, st))
                      for v in ("sparsedrive",)},
        "vad": vad, "vad_init": jax.jit(vad.init), "tx": tx, "step": jax.jit(step),
    }


def _channel_share_apart(got, want, ch):
    return float((got[..., ch] != want[..., ch]).mean())


def test_cameras_match_jax(setup):
    """render_cameras on the reset, after 10 ticks of the port's env and
    with a vehicle planted 10 m ahead of ego 0 (other agents dead); the
    target points and speeds of e2e_inputs; the static pixel ground table
    and the projections of the BEV cell centres and of random points."""
    st, env = setup["state"], setup["env"]
    crit = setup["crit"]
    env.tick = 0  # the reset's tick
    states = [st]
    for _ in range(10):
        st, crit = env.step(st, crit)
    states.append(st)
    ego_pos, h = st.pos[0, 0], st.heading[0, 0]
    alive = torch.zeros_like(st.alive)
    alive[:, :2] = True
    states.append(st.replace(
        pos=st.pos.clone().index_put_((torch.tensor(0), torch.tensor(1)),
                                      ego_pos + 10.0 * torch.stack([torch.cos(h), torch.sin(h)])),
        heading=st.heading.clone().index_put_((torch.tensor(0), torch.tensor(1)), h),
        alive=alive, agent_class=torch.zeros_like(st.agent_class)))
    for i, tst in enumerate(states):
        jst = to_jax(tst, setup["jstate"])
        got = sensors.render_cameras(setup["tmap"], setup["spec"], tst).numpy()
        want = np.asarray(setup["render"](setup["jspec"], jst))
        assert got.shape == want.shape == (S, 6, 24, 48, 8)
        for ch in range(8):
            if ch == sensors.CH_INV_DEPTH:
                np.testing.assert_allclose(got[..., ch], want[..., ch], atol=1e-6)
            else:
                assert set(np.unique(got[..., ch])) <= {0.0, 1.0}
                assert _channel_share_apart(got, want, ch) <= 1e-3, (i, ch)
        imgs, target, speed = e2e_inputs(setup["spec"], tst, setup["tmap"])
        _, jtarget, jspeed = setup["inputs"](setup["jspec"], jst)
        np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), atol=1e-4, rtol=1e-6)
        np.testing.assert_array_equal(speed.numpy(), np.asarray(jspeed))
    # the weather cut and the planted vehicle reach the pixels
    assert got[1, ..., sensors.CH_VALID].mean() < got[0, ..., sensors.CH_VALID].mean()
    assert got[0, 0, ..., sensors.CH_VEHICLE].sum() > 0 == got[0, 3, ..., sensors.CH_VEHICLE].sum()

    pts, hit = sensors.pixel_ground_table()
    jpts, jhit = jsensors.pixel_ground_table()
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    r = np.random.default_rng(0)
    for p in (bev_cell_centers(), r.uniform(-40, 60, (50, 2)).astype(np.float32)):
        uv, vis = sensors.project_points(torch.from_numpy(p))
        juv, jvis = jsensors.project_points(jnp.asarray(p))
        np.testing.assert_allclose(uv.numpy(), np.asarray(juv), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))


def test_closed_loop_with_e2e_ego(setup, tmp_path):
    """Eight ticks of the port's per-tick loop with a `sparsedrive` ego on
    seeded weights: each tick's waypoints against the JAX ego's on the same
    state, its params read from the port's npz; then `rollout_chunk` with
    ego kind "e2e" from the same reset, which must end on the same state
    and criteria bit for bit."""
    ego = EGO_POLICY_LIST["sparsedrive"](setup["tmap"], {"seed": 3})
    path = str(tmp_path / "sparsedrive.npz")
    ego.save(path)
    jparams = JAX_EGOS["sparsedrive"](setup["jmap"], {"weights": path}).params
    env = setup["env"]
    env.tick = 0  # the reset's tick
    state, crit = setup["state"], setup["crit"]
    for _ in range(8):
        wp = ego.act(setup["spec"], state)
        want = setup["waypoints"]["sparsedrive"](jparams, setup["jspec"],
                                                 to_jax(state, setup["jstate"]))
        np.testing.assert_allclose(wp.numpy(), np.asarray(want), **WP_TOL)
        state, crit = env.step(state, crit, ego_traj=wp)
    assert float(torch.linalg.norm(state.pos[:, 0] - setup["state"].pos[:, 0], dim=-1).min()) > 0

    fstate, fcrit, _ = rollout_chunk(None, setup["tmap"], setup["spec"], setup["state"],
                                     setup["crit"], num_steps=8, with_policy=False, ego="e2e",
                                     ego_model=ego.model, tick=0)
    assert_fields_match(state, fstate, atol=0.0)
    assert_fields_match(crit, fcrit, atol=0.0)


def test_bc_fit_and_train_ego_cli(setup, tmp_path, monkeypatch):
    """bc_rollout and bc_dataset over 30 ticks of the PDM expert: the
    dataset against the JAX package's on the same states; VAD's fit from
    the JAX initial params on it, the first two steps' losses against the
    JAX fit's (optax.chain(clip_by_global_norm(0.5), adamw)); then `python
    -m rift_tpu_torch.run --mode train_ego --ego_cfg sparsedrive`: its
    `sparsedrive_bc.npz` read by the JAX package's `E2EEgo.load` drives
    with the port's waypoints."""
    states = bc_rollout(setup["tmap"], setup["spec"], setup["state"], setup["crit"], 24)
    data = bc_dataset(setup["tmap"], setup["spec"], states)
    n = data["imgs"].shape[0]
    assert n == (24 - 20) * S
    # the JAX dataset with its per-tick inputs jitted (one compile, shared
    # with the camera test)
    monkeypatch.setattr(jax_train, "e2e_inputs", lambda sp, st, tm: setup["inputs"](sp, st))
    jdata = jax_train.bc_dataset(setup["jmap"], setup["jspec"],
                                 [to_jax(s, setup["jstate"]) for s in states])
    for key, want in jdata.items():
        got = data[key].numpy()
        if got.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=key)
        elif key == "imgs":
            for ch in range(8):
                assert float((np.abs(got[..., ch] - want[..., ch]) > 1e-6).mean()) <= 1e-3
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6, err_msg=key)

    # the fit, step by step, from the JAX initial params, on the same batches
    params = setup["vad_init"](jax.random.PRNGKey(0), jnp.asarray(jdata["imgs"][:1]),
                               jnp.asarray(jdata["target"][:1]), jnp.asarray(jdata["speed"][:1]))
    npz = str(tmp_path / "vad0.npz")
    jax_save_params(params, npz)
    model = E2EModel("vad")
    load_jax_params(model, flatten_params(load_params_npz(npz)))
    got = bc_fit(model, data, epochs=1, batch_size=4, seed=0)
    opt_state = setup["tx"].init(params)
    order = np.random.default_rng(0).permutation(n)
    want = []
    for i in range(2):
        idx = order[4 * i:4 * i + 4]
        batch = {k: jnp.asarray(v.numpy()[idx]) for k, v in data.items()}
        params, opt_state, loss = setup["step"](params, opt_state, batch)
        want.append(float(loss))
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)

    out = str(tmp_path / "log")
    run.main(["--mode", "train_ego", "--ego_cfg", "sparsedrive", "--device", "cpu",
              "--town", "straight", "--num_scenario", "2", "--num_agents", "8",
              "--num_episodes", "1", "--max_ticks", "28", "--out_dir", out])
    npz = f"{out}/train_ego/sparsedrive-rift_pluto-seed0/model_ckpt/sparsedrive_bc.npz"
    jego = JAX_EGOS["sparsedrive"](setup["jmap"])
    jego.load(npz)
    ego = EGO_POLICY_LIST["sparsedrive"](setup["tmap"], {"weights": npz})
    wp = e2e_ego_waypoints(ego.model, setup["tmap"], setup["spec"], setup["state"])
    want = setup["waypoints"]["sparsedrive"](jego.params, setup["jspec"], setup["jstate"])
    np.testing.assert_allclose(wp.numpy(), np.asarray(want), **WP_TOL)
