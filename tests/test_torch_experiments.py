"""The port's experiment protocols (rift_tpu_torch/tools: quality_experiment,
ego_zoo_experiment, topology_eval) against the JAX package's (tools/), on
the CPU without compiling a JAX program.

The two protocols run with their `run_cli` (and the ego zoo's
`plant_train`) replaced by one recorder, which writes the artifacts each
next stage looks for: npz files, an empty HDF5 file, and a
`simulation_results.json` of an eval episode of the port's env. Both
packages' tools must make the same sequence of calls (the port's output
root mapped to the JAX tool's, the port's `--cpu` to its `--device cpu`),
at full scale and under `--smoke`, and write the same merged tables and
the same RESULTS.md, but for the header line that names the tool and the
device (and, in the quality table, the line that names the JAX package's
TPU world model). Every output root, the JAX tools' `ROOT` included, is a
temporary directory. The topology eval's route search must pick the same routes
and lane paths on the two grid towns, and the verdicts of its lane-trace
check must be those of a numpy transcription, on a short port run and on
a route's own lane path.
"""

import importlib.util
import itertools
import os
import shutil
import sys
import types

import numpy as np
import pytest

from rift_tpu_torch.tools import ego_zoo_experiment, quality_experiment, topology_eval
from torch_parity import eval_results_files, load_tool, one_torch_thread  # noqa: F401

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


@pytest.fixture(scope="module")
def results_files(tmp_path_factory):
    """Four eval episodes of the port's env (seeds 0-3), which the
    recorder hands out as the eval runs' results."""
    base = tmp_path_factory.mktemp("episodes")
    return eval_results_files([(base / f"r{seed}.json", seed) for seed in range(4)])


class Recorder:
    """run_cli and plant_train of both packages' protocols: each call
    recorded, and the artifact its stage makes written."""

    def __init__(self, results_files):
        self.results_files = results_files
        self.calls = []

    def run_cli(self, argv, cpu=False):
        self.calls.append(("run", list(argv), cpu))
        arg = lambda k, d=None: argv[argv.index(k) + 1] if k in argv else d
        mode, out = arg("--mode"), arg("--out_dir")
        ego, cbv, seed = arg("--ego_cfg"), arg("--cbv_cfg"), int(arg("--seed", 0))
        run_dir = os.path.join(out, mode, f"{ego}-{cbv}-seed{seed}")
        if mode == "train_cbv":
            self._npz(arg("--save_pretrain"))
        elif mode == "collect_data":
            os.makedirs(run_dir, exist_ok=True)
            open(os.path.join(run_dir, f"{ego}_{cbv}.hdf5"), "wb").close()
        elif mode == "train_ego":
            self._npz(os.path.join(run_dir, "model_ckpt", f"{ego}_bc.npz"))
        else:
            os.makedirs(run_dir, exist_ok=True)
            src = self.results_files[(seed + len(cbv) + len(ego)) % len(self.results_files)]
            shutil.copy(src, os.path.join(run_dir, "simulation_results.json"))

    def plant_train(self, argv):
        self.calls.append(("plant", list(argv)))
        self._npz(argv[argv.index("--out") + 1])

    @staticmethod
    def _npz(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, w=np.zeros(2, np.float32))


def mapped(calls, port_root, jax_root):
    """The port's calls as the JAX tool makes them: the output root
    replaced, and its `--cpu` (every call's) dropped."""
    out = []
    for call in calls:
        assert call[-1] is True if call[0] == "run" else call[1][-2:] == ["--device", "cpu"]
        argv = call[1] if call[0] == "run" else call[1][:-2]
        out.append((call[0], [a.replace(port_root, jax_root) for a in argv])
                   + ((False,) if call[0] == "run" else ()))
    return out


def same_but_header(port_md, jax_md, tool, world_model=False):
    """The two RESULTS.md files agree line for line, but the header line, which names
    the tool and the device, and, with `world_model`, the line that names
    the JAX package's TPU world model."""
    with open(port_md) as f, open(jax_md) as g:
        a, b = f.read().splitlines(), g.read().splitlines()
    assert len(a) == len(b) > 10
    apart = [(x, y) for x, y in zip(a, b) if x != y]
    assert len(apart) == 1 + world_model, apart
    assert f"rift_tpu_torch.tools.{tool}" in apart[0][0] and f"tools/{tool}.py" in apart[0][1]
    if world_model:
        assert "TPU world model" in apart[1][1] and "TPU" not in apart[1][0]


def test_quality_protocol_matches_jax(tmp_path, monkeypatch, results_files):
    jq = load_tool(os.path.join(TOOLS, "quality_experiment.py"), "jax_quality_experiment")
    routes = str(tmp_path / "routes.xml")
    for smoke in (False, True):
        root = tmp_path / ("smoke" if smoke else "full")
        jrec, rec = Recorder(results_files), Recorder(results_files)
        monkeypatch.setattr(jq, "ROOT", str(root / "jax"))
        monkeypatch.setattr(jq, "run_cli", jrec.run_cli)
        monkeypatch.setattr(quality_experiment, "ROOT", str(root / "port"))
        monkeypatch.setattr(quality_experiment, "run_cli", rec.run_cli)
        flags = ["--routes", routes] + (["--smoke"] if smoke else [])
        jout, out = str(root / "jax" / "log"), str(root / "port" / "log")
        monkeypatch.setattr(sys, "argv", ["quality_experiment.py", *flags, "--out", jout])
        jmerged = jq.main()
        merged = quality_experiment.main([*flags, "--out", out, "--cpu"])
        assert mapped(rec.calls, out, jout) == jrec.calls
        assert len(rec.calls) == (5 if smoke else 1 + 7 + 9 * 3)
        assert merged == jmerged and len(merged) == (3 if smoke else 9)
        assert all("±" in row["Driving Score"] for row in merged.values())
        # a second run reuses every artifact and runs nothing
        rec.calls.clear()
        assert quality_experiment.main([*flags, "--out", out, "--cpu"]) == merged
        assert rec.calls == []
        res = root / "port" / "results" / "torch" / "quality"
        jres = root / "jax" / "results" / "quality"
        if smoke:  # no table at the smoke scale
            assert not res.exists() and not jres.exists()
            continue
        same_but_header(res / "RESULTS.md", jres / "RESULTS.md", "quality_experiment",
                        world_model=True)
        assert sorted(os.listdir(res / "runs")) == sorted(os.listdir(jres / "runs"))
        assert (res / "merged.json").read_text() == (jres / "merged.json").read_text()


def test_ego_zoo_protocol_matches_jax(tmp_path, monkeypatch, results_files):
    import rift_tpu.models.plant.train as jplant

    jz = load_tool(os.path.join(TOOLS, "ego_zoo_experiment.py"), "jax_ego_zoo_experiment")
    quality = tmp_path / "quality"
    Recorder._npz(str(quality / "pluto_pretrain.npz"))
    Recorder._npz(str(quality / "rift_pluto.npz"))
    routes = str(tmp_path / "routes.xml")
    for smoke in (False, True):
        root = tmp_path / ("smoke" if smoke else "full")
        jrec, rec = Recorder(results_files), Recorder(results_files)
        monkeypatch.setattr(jz, "ROOT", str(root / "jax"))
        monkeypatch.setattr(jz, "run_cli", jrec.run_cli)
        monkeypatch.setattr(jplant, "main", jrec.plant_train)
        monkeypatch.setattr(ego_zoo_experiment, "ROOT", str(root / "port"))
        monkeypatch.setattr(ego_zoo_experiment, "run_cli", rec.run_cli)
        monkeypatch.setattr(ego_zoo_experiment, "plant_train", rec.plant_train)
        flags = ["--routes", routes, "--quality_artifacts", str(quality)]
        flags += ["--smoke"] if smoke else []
        jout, out = str(root / "jax" / "log"), str(root / "port" / "log")
        monkeypatch.setattr(sys, "argv", ["ego_zoo_experiment.py", *flags, "--out", jout])
        jmerged = jz.main()
        merged = ego_zoo_experiment.main([*flags, "--out", out, "--cpu"])
        assert mapped(rec.calls, out, jout) == jrec.calls
        # collect, PlanT, E2E BC, then the eval matrix: PlanT x 3 CBVs, the
        # E2E egos and the untrained baseline, x seeds
        assert len(rec.calls) == (1 + 1 + 1 + 3 if smoke else 1 + 1 + 3 + (3 + 3 + 1) * 3)
        assert merged == jmerged and len(merged) == (2 if smoke else 6)
        res = root / "port" / "results" / "torch" / "ego_zoo"
        jres = root / "jax" / "results" / "ego_zoo"
        if smoke:
            assert not res.exists() and not jres.exists()
            continue
        same_but_header(res / "RESULTS.md", jres / "RESULTS.md", "ego_zoo_experiment")
        assert sorted(os.listdir(res / "runs")) == sorted(os.listdir(jres / "runs"))
    # without h5py, stage 1 stops before it starts a run
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else find_spec(name, *a))
    rec = Recorder(results_files)
    monkeypatch.setattr(ego_zoo_experiment, "run_cli", rec.run_cli)
    with pytest.raises(ImportError, match="h5py"):
        ego_zoo_experiment.main(["--smoke", "--routes", routes, "--out", str(tmp_path / "no")])
    assert rec.calls == []


def lane_trace_transcription(trace, is_junction, left, right):
    """The topology eval's verdicts, transcribed: per scenario, the lanes
    visited in order (repeats merged), whether one is an adjacent lane of
    the one before, and the distinct junction lanes among them."""
    out = []
    for lanes in np.asarray(trace).T:
        visited = [int(k) for k, _ in itertools.groupby(lanes.tolist())]
        steps = zip(visited, visited[1:])
        out.append({"lane_change": any(b in (left[a], right[a]) for a, b in steps),
                    "junction_lanes": len({v for v in visited if is_junction[v]})})
    return out


def test_topology_routes_and_lane_trace(monkeypatch):
    import torch

    from rift_tpu.map import make_grid_town as jax_grid_town
    from rift_tpu_torch.map import make_grid_town

    jt = load_tool(os.path.join(TOOLS, "topology_eval.py"), "jax_topology_eval")
    jmap = jax_grid_town(blocks=2, num_lanes=2)
    tmap = make_grid_town(blocks=2, num_lanes=2, device="cpu")
    tmap = tmap.replace(light_group=torch.full_like(tmap.light_group, -1))
    for seed in (0, 1):
        jroutes, jpaths = jt.find_topology_routes(jmap, 4, seed)
        routes, paths = topology_eval.find_topology_routes(tmap, 4, seed)
        assert paths == jpaths
        for r, jr in zip(routes, jroutes):
            np.testing.assert_allclose(r, jr, atol=1e-5)
    isj, left, right = (np.asarray(getattr(jmap, k)) for k in ("is_junction", "left_adj",
                                                                "right_adj"))
    # a route's lane path is a trace with a lane change and >= 3 junction lanes
    for path in paths:
        trace = np.repeat(np.asarray(path)[:, None], 2, axis=0)
        want = lane_trace_transcription(trace, isj, left, right)
        assert topology_eval.lane_trace_verdicts(tmap, trace) == want
        assert want[0]["lane_change"] and want[0]["junction_lanes"] >= 3
    # a short closed-loop run: run_one's verdicts on the trace it simulated
    lanes = []

    def recorded(*a, **kw):
        out = rollout_chunk(*a, **kw)
        lanes.append(out[0].lane[:, 0].numpy().copy())
        return out

    rollout_chunk = topology_eval.rollout_chunk
    monkeypatch.setattr(topology_eval, "rollout_chunk", recorded)
    args = types.SimpleNamespace(num_agents=8, seed=0, ticks=20, pretrain="")
    env0 = topology_eval.TrafficEnv(tmap, num_scenarios=4, num_agents=8, max_cbvs=2, seed=0,
                                    num_walkers=0, num_statics=0, device="cpu")
    first = env0.reset(routes=routes, lane_paths=paths)[0].lane[:, 0].numpy()
    g, verify, ds = topology_eval.run_one(tmap, routes, paths, "standard", args)
    assert len(lanes) == 4 and len(ds) == 4 and np.isfinite(g["avg_driving_score"])
    assert verify == lane_trace_transcription(np.stack([first, *lanes]), isj, left, right)
