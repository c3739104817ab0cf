"""The pipelined rounds from the command line on the CPU: the training
CLI's ``--pipeline`` (rows with the pipeline's keys and the simulated
clock line; ``--adversary`` refused) in subprocesses on one thread each,
and ``launch.pipeline_bench``'s smoke sweep in process.  A file of its own
so that ``--dist loadfile`` runs it beside ``tests/test_torch_pipeline.py``.
"""

import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import pipeline_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_train_cli_pipeline_runs_on_cpu():
    proc = _train("--reduced", "--rounds", "4", "--clients", "8",
                  "--cohort", "2", "--pipeline", "--staleness", "1",
                  "--latency-dist", "benchmarks/artifacts/latency_dist.json",
                  "--round-policy", "quorum", "--quorum", "1",
                  "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    rows = [ln for ln in proc.stderr.splitlines() if "round=" in ln]
    assert len(rows) == 4, proc.stderr
    for key in ("staleness=1", "dispatch_s=", "commit_s=",
                "round_latency_s=", "admitted=", "late_dropped=",
                "uncovered="):
        assert all(key in r for r in rows), (key, rows)
    m = re.search(r"\[train\] simulated clock: ([0-9.]+)s at staleness 1",
                  proc.stdout)
    assert m and float(m.group(1)) > 0, proc.stdout
    m = re.search(r"final loss (\S+)$", proc.stdout.strip())
    assert m and math.isfinite(float(m.group(1))), proc.stdout


def test_train_cli_pipeline_refuses_an_adversary():
    proc = _train("--reduced", "--rounds", "1", "--pipeline", "--adversary",
                  "sign_flip", "--f-byz", "0.25", "--device", "cpu")
    assert proc.returncode == 2 and "--adversary" in proc.stderr


def test_pipeline_bench_smoke_on_cpu(tmp_path):
    out = tmp_path / "pipeline_bench.json"
    assert pipeline_bench.main(["--smoke", "--device", "cpu", "--out",
                                str(out)]) == 0
    blob = json.loads(out.read_text())
    rows = blob["rows"]
    assert [(r["tau"], r["policy"]) for r in rows] == [
        (0, "wait_all"), (1, "wait_all"), (1, "quorum")]
    assert all(r["finite"] and r["clock_s"] > 0 for r in rows)
    # every member arrives under wait_all; quorum 1 drops the rest
    assert rows[1]["admitted_total"] == 2 * blob["config"]["rounds"]
    assert rows[2]["late_dropped_total"] > 0
    assert rows[0]["local_steps"] == rows[1]["local_steps"]
    assert pipeline_bench.main(["--smoke", "--device", "cpu", "--out",
                                str(tmp_path / "BENCH_pipeline.json")]) == 2
