"""The port stands alone: no jax, no ``repro`` and no ``benchmarks`` at run
time, the GPU by default with no quiet fallback to the CPU, and CLIs that
train and serve on the CPU when asked."""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    # one thread per subprocess: beside the suite's other workers a full
    # thread pool slows a CLI training run many times over
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    code = """
import importlib, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="not_main")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro.")
             or m == "benchmarks" or m.startswith("benchmarks."))
assert {"repro_torch.dist.wire", "repro_torch.kernels.wire_pack",
        "repro_torch.core.masks", "repro_torch.core.compression",
        "repro_torch.core.problems", "repro_torch.core.tamuna",
        "repro_torch.core.theory", "repro_torch.kernels.decode_attn",
        "repro_torch.serve_utils", "repro_torch.launch.serve",
        "repro_torch.launch.convex_bench", "repro_torch.core.baselines",
        "repro_torch.launch.paper_bench", "repro_torch.launch.train",
        "repro_torch.configs.gemma2_9b", "repro_torch.configs.stablelm_3b",
        "repro_torch.configs.deepseek_coder_33b",
        "repro_torch.configs.internvl2_26b", "repro_torch.optim.optimizers",
        "repro_torch.checkpoint", "repro_torch.dist.block_uplink",
        "repro_torch.dist.rounds", "repro_torch.dist.cohort",
        "repro_torch.launch.pipeline_bench", "repro_torch.models.moe",
        "repro_torch.models.rwkv", "repro_torch.models.ssm",
        "repro_torch.configs.qwen2_moe_a2p7b",
        "repro_torch.configs.qwen3_moe_30b_a3b",
        "repro_torch.configs.rwkv6_7b",
        "repro_torch.configs.zamba2_2p7b", "repro_torch.models.encdec",
        "repro_torch.configs.whisper_tiny", "repro_torch.examples",
        "repro_torch.examples.quickstart",
        "repro_torch.examples.federated_sim",
        "repro_torch.examples.availability_sim",
        "repro_torch.examples.train_lm",
        "repro_torch.examples.serve_decode"} <= set(names)
from repro_torch.configs import registry
assert len(registry.list_archs()) == 10
for arch in registry.list_archs():
    registry.get_config(arch), registry.get_reduced_config(arch)
print(len(names), bad)
"""
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 40
    assert bad.strip() == "[]", bad


def _default_device_calls():
    from repro_torch._device import resolve_device
    from repro_torch import convert
    from repro_torch.configs import gemma2_2b
    from repro_torch.core import problems
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import model_api, tamuna_dp
    from repro_torch.dist import rounds
    from repro_torch.launch import (convex_bench, paper_bench,
                                    pipeline_bench, serve, train)

    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.5)
    return {
        "resolve_device": lambda: resolve_device(),
        "model_api.init": lambda: model_api.init(cfg),
        "init_state": lambda: tamuna_dp.init_state(cfg, tcfg, 4),
        "make_comm_step": lambda: tamuna_dp.make_comm_step(cfg, tcfg, 4),
        "pipeline": lambda: SyntheticTokenPipeline(
            DataConfig(n_clients=4), cfg),
        "train.main": lambda: train.main(["--reduced", "--rounds", "1"]),
        "make_logreg_problem": lambda: problems.make_logreg_problem(
            n=4, d=8, samples_per_client=2),
        "make_quadratic_problem": lambda: problems.make_quadratic_problem(
            n=4, d=8),
        "convex_problem_from_numpy": lambda: convert.convex_problem_from_numpy(
            {"diag": np.ones(3), "t": np.zeros((2, 3))}, mu=1.0, L=1.0),
        "tamuna_state_from_numpy": lambda: convert.tamuna_state_from_numpy(
            np.zeros(3), np.zeros((2, 3))),
        "make_cache": lambda: model_api.make_cache(cfg, 1, 8),
        "cache_from_numpy": lambda: convert.cache_from_numpy(
            {"k": np.zeros((1, 1, 2, 1, 4), np.float32),
             "v": np.zeros((1, 1, 2, 1, 4), np.float32)}),
        "serve.main": lambda: serve.main(["--reduced", "--batch", "1",
                                          "--prompt-len", "2",
                                          "--gen-len", "1"]),
        "convex_bench.main": lambda: convex_bench.main(
            ["--smoke", "--only", "robust", "--out", os.devnull]),
        "paper_bench.main": lambda: paper_bench.main(
            ["--smoke", "--only", "table2", "--out", os.devnull]),
        "make_pipelined_round_fn": lambda: rounds.make_pipelined_round_fn(
            cfg, tcfg, 4, pipe=None),
        "pipeline_bench.main": lambda: pipeline_bench.main(
            ["--smoke", "--out", os.devnull]),
    }


@pytest.mark.parametrize("entry", ["resolve_device", "model_api.init",
                                   "init_state", "make_comm_step",
                                   "pipeline", "train.main",
                                   "make_logreg_problem",
                                   "make_quadratic_problem",
                                   "convex_problem_from_numpy",
                                   "tamuna_state_from_numpy", "make_cache",
                                   "cache_from_numpy", "serve.main",
                                   "convex_bench.main", "paper_bench.main",
                                   "make_pipelined_round_fn",
                                   "pipeline_bench.main"])
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _default_device_calls()[entry]()


def test_train_cli_runs_on_cpu_when_asked():
    proc = _run(["-m", "repro_torch.launch.train", "--arch", "gemma2-2b",
                 "--reduced", "--rounds", "2", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"on cpu in [0-9.]+s; final loss (\S+)$",
                  proc.stdout.strip())
    assert m, proc.stdout
    assert math.isfinite(float(m.group(1))), proc.stdout
