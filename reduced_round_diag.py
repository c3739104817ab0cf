#!/usr/bin/env python3
"""The first reduced gemma2-2b round of ``chip_smoke.py`` (fault-free,
n=4 c=3 s=2) evaluated several ways, each in a fresh process on one CUDA
device:

- the cohort rows after the two local steps on the card (twice), on the
  CPU with its default intra-op threads (twice) and with one thread
  (twice), each against a float64 evaluation of the same steps on the CPU
  (the model with a float64 compute dtype);
- the error ``chip_smoke.py`` gates at 1e-5 (card vs CPU over the whole
  round), with either CPU setting;
- the card's local steps and the gated round again after the caching
  allocator was filled with NaN and released (an op that reads memory it
  did not write would show).

Each process prints one JSON line; the spread of every number over the
processes follows.  A diagnostic of the reduced round's card-vs-CPU gate,
not a check: it gates nothing and prints no device record.

  python3 reduced_round_diag.py [--processes N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import chip_smoke as smoke  # noqa: E402


def local_f64(cfg, tcfg, n, cohort, toks, noise) -> torch.Tensor:
    """The round's two local steps in float64 on the CPU (the model with a
    float64 compute dtype, ``x - gamma (g - h)`` in float64): the ``(n,
    d_total)`` trained workspace."""
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    state.x[1:] += noise
    x, h = state.x.double(), state.h.double()
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    for t in range(toks.shape[0]):
        for a, i in enumerate(cohort):
            xs = comm_ws.leaf_views(x[i], state.spec)
            hs = comm_ws.leaf_views(h[i], state.spec)
            params = {k: v.detach().requires_grad_(True)
                      for k, v in xs.items()}
            loss, _ = model_api.loss(params, cfg64,
                                     tokens=toks[t, a, :, :-1],
                                     labels=toks[t, a, :, 1:])
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for (name, xv), g in zip(xs.items(), grads):
                    xv -= tcfg.gamma * (g - hs[name])
    return x


def fill_allocator_with_nan(dev) -> None:
    """Fill 80% of the free device memory with NaN through the caching
    allocator and release it to the cache."""
    free, _ = torch.cuda.mem_get_info()
    pool = torch.full((int(free * 0.8) // 4,), float("nan"), device=dev)
    del pool


def once(dev) -> dict:
    """One process's evaluations (see the module's docstring)."""
    from repro_torch.dist import tamuna_dp

    n, c, s, cohort = smoke.N, smoke.C, smoke.S, [0, 2, 3]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=smoke.GAMMA, c=c, s=s,
                                      p=smoke.P)
    cfg, toks, noise = smoke.reduced_round_inputs(n, c)
    x64 = local_f64(cfg, tcfg, n, cohort, toks, noise)[cohort]
    runs = {}
    for tag, device, k in (("card", dev, None), ("card_b", dev, None),
                           ("cpu", "cpu", None), ("cpu_b", "cpu", None),
                           ("cpu1", "cpu", 1), ("cpu1_b", "cpu", 1)):
        with smoke.intra_op_threads(k):
            state, _ = smoke.reduced_local(device, cfg, tcfg, n, cohort,
                                           toks, noise)
        runs[tag] = state.x[cohort].cpu()
    res = {"cpu_threads": torch.get_num_threads()}
    for tag in ("card", "cpu", "cpu1"):
        res[f"{tag}_vs_f64"] = float((runs[tag].double() - x64).abs().max())
        res[f"{tag}_repeat"] = smoke.max_abs_err(runs[tag], runs[tag + "_b"])
    res["card_vs_cpu1"] = smoke.max_abs_err(runs["card"], runs["cpu1"])
    args = (dev, n, c, s, cohort, [2, 0, 1], [True, True, False, True])
    res["gate_err_cpu"], res["gate_where_cpu"] = smoke.reduced_round_err(
        *args)
    with smoke.intra_op_threads(1):
        res["gate_err_cpu1"], _ = smoke.reduced_round_err(*args)
    fill_allocator_with_nan(dev)
    state, _ = smoke.reduced_local(dev, cfg, tcfg, n, cohort, toks, noise)
    res["card_after_nan_pool"] = smoke.max_abs_err(runs["card"],
                                                   state.x[cohort].cpu())
    del state
    fill_allocator_with_nan(dev)
    with smoke.intra_op_threads(1):
        res["gate_err_cpu1_after_nan_pool"], _ = smoke.reduced_round_err(
            *args)
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=4,
                    help="fresh processes to run the evaluations in")
    ap.add_argument("--once", action="store_true",
                    help="run the evaluations in this process only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("reduced_round_diag: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    if args.once:
        print(json.dumps(once(torch.device("cuda", 0))))
        return 0
    print(f"[card] {smoke.smi()}")
    rows = []
    for i in range(args.processes):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--once"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"diagnostic process {i} failed")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(f"[reduced_diag] process {i}: {json.dumps(row)}")
    for key in rows[0]:
        if isinstance(rows[0][key], float):
            vals = [r[key] for r in rows]
            print(f"[reduced_diag] {key}: min {min(vals):.6e} max "
                  f"{max(vals):.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
