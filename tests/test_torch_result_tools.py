"""The port's result tools (rift_tpu_torch/tools: merge_statistics,
check_eval, runs) against the JAX package's (tools/), on result files and
run directories that the port writes on the CPU: two seeds of an eval
episode of the port's env, laid out as the CLI's out_dir scheme, and two
run directories of the port's `init_run`.

Both packages' tools must give the same seed groups, the same merged
"mean ± std" strings (string for string) and merged.json, the same check
counts and exit codes (also on a corrupted file), and the same printed
`runs list`, `compare` and `show` output. No JAX program is compiled.
"""

import json
import os
import shutil

import numpy as np
import pytest

from rift_tpu_torch.tools import check_eval, merge_statistics, runs
from torch_parity import eval_results_files, load_tool, one_torch_thread  # noqa: F401

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


@pytest.fixture(scope="module")
def seed_runs(tmp_path_factory):
    """Two seeds of a small eval of the port's env, as run.py lays them out."""
    base = tmp_path_factory.mktemp("eval")
    runs = []
    for seed in (0, 1):
        d = base / f"pdm_lite-rift_pluto-seed{seed}"
        d.mkdir()
        runs.append((d / "simulation_results.json", seed))
    eval_results_files(runs)
    return str(base)


def test_merge_statistics_matches_jax(seed_runs, tmp_path):
    jmerge = load_tool(os.path.join(TOOLS, "merge_statistics.py"), "jax_merge_statistics")
    runs_found = merge_statistics.find_seed_runs(seed_runs)
    assert runs_found == jmerge.find_seed_runs(seed_runs)
    assert sorted(runs_found["pdm_lite-rift_pluto"]) == [0, 1]
    paths = [p for _, p in sorted(runs_found["pdm_lite-rift_pluto"].items())]
    table, jtable = merge_statistics.seed_table(paths[0]), jmerge.seed_table(paths[0])
    assert list(table) == list(jtable)
    for k in table:
        np.testing.assert_allclose(table[k], jtable[k], rtol=1e-12, err_msg=k)
    out, jout = str(tmp_path / "merged.json"), str(tmp_path / "jax_merged.json")
    merged = merge_statistics.main(["--base_dir", seed_runs, "--out", out])
    jmerged = jmerge.main(["--base_dir", seed_runs, "--out", jout])
    assert merged == jmerged
    row = merged["pdm_lite-rift_pluto"]
    # the tuples' NaN branch too: no CBV came close enough for a TTC
    assert "±" in row["Driving Score"] and "±" in row["RP"] and row["RTTC"] == "n/a"
    with open(out) as f, open(jout) as g:
        assert json.load(f) == json.load(g)


def test_check_eval_matches_jax(seed_runs, tmp_path):
    jcheck = load_tool(os.path.join(TOOLS, "check_eval.py"), "jax_check_eval")
    base = str(tmp_path / "eval")
    shutil.copytree(seed_runs, base)
    for argv in (["--base_dir", base], ["--base_dir", base, "--expected_routes", "2"]):
        assert check_eval.main(argv) == jcheck.main(argv) == 2
    with pytest.raises(SystemExit) as e:
        check_eval.main(["--base_dir", base, "--expected_routes", "3"])
    with pytest.raises(SystemExit) as je:
        jcheck.main(["--base_dir", base, "--expected_routes", "3"])
    assert e.value.code == je.value.code == 1
    bad = os.path.join(base, "pdm_lite-rift_pluto-seed0", "simulation_results.json")
    with open(bad) as f:
        data = json.load(f)
    data["records"][0]["driving_score"] = 250.0
    data["records"][1]["status"] = "Crashed"
    with open(bad, "w") as f:
        json.dump(data, f)
    errors = check_eval.check_file(bad)
    assert errors == jcheck.check_file(bad) and len(errors) == 2
    with pytest.raises(SystemExit) as e:
        check_eval.main(["--base_dir", base])
    with pytest.raises(SystemExit) as je:
        jcheck.main(["--base_dir", base])
    assert e.value.code == je.value.code == 1


def test_runs_cli_matches_jax(tmp_path, capsys):
    from rift_tpu_torch.utils.tracking import init_run

    jruns = load_tool(os.path.join(TOOLS, "runs.py"), "jax_runs")
    base = str(tmp_path)
    for seed in (0, 1):
        r = init_run("eval", name=f"s{seed}", config={"seed": seed}, base_dir=base)
        r.log({"driving_score": 90.0 + seed, "loss": 0.5 / (seed + 1)})
        r.log({"driving_score": 91.5 + seed}, step=1)
        r.finish()
    run_dir = os.path.join(base, "eval", sorted(os.listdir(os.path.join(base, "eval")))[0])
    capsys.readouterr()
    for argv in (["list"], ["list", "--project", "eval"], ["list", "--project", "train_cbv"],
                 ["compare", "--keys", "driving_score,loss"], ["show", run_dir, "--tail", "1"]):
        runs.main(["--base_dir", base, *argv])
        out = capsys.readouterr().out
        jruns.main(["--base_dir", base, *argv])
        assert out == capsys.readouterr().out, argv
        assert out
    runs.main(["--base_dir", base, "compare", "--keys", "driving_score"])
    out = capsys.readouterr().out
    assert "s0" in out and "s1" in out and "92.5" in out
