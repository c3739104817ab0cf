"""The training CLI's robust and reputation paths on the CPU
(``repro_torch.launch.train``): a trimmed combiner against a sign-flipping
adversary, with and without the anomaly reputation, and the refusal of
``--reputation`` without an adversary.  It runs the CLI in subprocesses
on one thread each and takes a file of its own so that ``--dist
loadfile`` runs it beside ``tests/test_torch_robust.py``."""

import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_cli_robust_adversary_runs_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    # one thread per CLI run: beside the suite's other workers a full
    # thread pool per subprocess slows the run many times over
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    args = ["--reduced", "--rounds", "2", "--sparsity", "3",
            "--robust-agg", "trimmed", "--trim-k", "1",
            "--adversary", "sign_flip", "--f-byz", "0.25", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"final loss (\S+)$", proc.stdout.strip())
    assert m and math.isfinite(float(m.group(1))), proc.stdout
    assert "arrivals=" in proc.stderr
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--reputation"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert rep.returncode == 0, rep.stderr
    m = re.search(r"final loss (\S+)$", rep.stdout.strip())
    assert m and math.isfinite(float(m.group(1))), rep.stdout
    # every round's row carries the anomaly maximum
    anomaly = re.findall(r"anomaly_max=(\S+)", rep.stderr)
    assert len(anomaly) == 2 and all(math.isfinite(float(a))
                                     for a in anomaly), rep.stderr
    no_adv = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--rounds", "1", "--reputation", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert no_adv.returncode == 2 and "--adversary" in no_adv.stderr
