#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, train.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package ``repro``, and in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels of ``src/repro_torch/kernels/csrc/`` with nvcc
   for sm_90a and prints the build time and ptxas' register report;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path (gemma2-2b at published widths cut to 2 layers:
   an ``(n=4, d=745,558,272)`` f32 workspace with an idle row of NaN and a
   ragged tail, and the largest leaf ``(256000, 2304)`` for the local
   step), timing both with CUDA events;
4. runs one round of the reduced gemma2-2b config on the card and on the
   CPU with the same injected schedule and batches, and compares them;
5. drives the main path: ``repro_torch.dist.rounds.run_rounds`` for 3
   rounds of 2-layer full-width gemma2-2b (n=4 clients, cohort c=3,
   sparsity s=2, seq 128, 2 sequences per client, max_L 4) with the launch
   counts set to 0 just before and read just after, and checks finite
   losses, a launch of every kernel and the invariant sum_i h_i = 0.

Any failure raises and exits non-zero.  The last two lines of standard
output are the kernels' JSON record and the device JSON record; the card's
name and power limit come on the line before them.

It exits non-zero without a result when no CUDA device is present, and
when it stands in a directory without the rest of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM device-memory rate (NVIDIA data sheet), the bound of all three
# kernels: they do O(1) operations per byte.
HBM_BYTES_PER_S = 3.35e12

N, C, S = 4, 3, 2  # clients, cohort, sparsity of the main path
GAMMA, P = 0.05, 0.34


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def owned_entries(slot, band, m: int, s: int) -> int:
    """How many (row, coordinate) pairs the slots own: the x entries the
    UpCom must read and the h entries the update must touch."""
    per_band = torch.bincount(band, minlength=m).tolist()
    total = 0
    for sl in slot.tolist():
        if 0 <= sl < m:
            total += sum(cnt for b, cnt in enumerate(per_band)
                         if (sl + b) % m < s)
    return total


def max_abs_err(a, b, chunk: int = 1 << 26) -> float:
    """max |a - b| over same-shape tensors, NaN where both are NaN counted
    as equal, in column chunks so no full-size temporary is made."""
    a2, b2 = a.reshape(-1), b.reshape(-1)
    err = 0.0
    for i in range(0, a2.numel(), chunk):
        x, y = a2[i:i + chunk], b2[i:i + chunk]
        both_nan = x.isnan() & y.isnan()
        if bool((x.isnan() ^ y.isnan()).any()):
            return math.inf
        d = (x - y).abs().masked_fill(both_nan, 0.0)
        err = max(err, float(d.max()))
    return err


def check_uplink_kernels(spec, tcfg, dev):
    """masked_sum and h_update against their plain versions on the full
    workspace; returns their records."""
    from repro_torch.dist import comm_ws
    from repro_torch.kernels import ref, uplink

    n, d = N, spec.d_total
    g = torch.Generator(device=dev).manual_seed(1)
    band = comm_ws.cyclic_band(spec.dims, C, S, dev)
    slot = torch.tensor([1, -1, 0, 2], dtype=torch.int32, device=dev)
    down = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=dev)
    x = torch.randn(n, d, generator=g, device=dev)
    x[1] = float("nan")  # the idle row may hold anything
    scale = tcfg.eta_(n) / tcfg.gamma
    owned = owned_entries(slot, band, C, S)
    n_down = int(down.sum())
    print(f"[check] workspace ({n}, {d}) f32, slot {slot.tolist()}, "
          f"down {down.tolist()}, {owned} owned entries")

    xbar = uplink.masked_sum(x, slot, band, C, S)
    xbar_p = ref.masked_sum(x, slot, band, C, S)
    torch.cuda.synchronize()
    ms_err = max_abs_err(xbar, xbar_p)
    ms_tol = 1e-6 * float(xbar_p.abs().max())
    del xbar_p
    if not bool(xbar.isfinite().all()) or ms_err > ms_tol:
        raise AssertionError(f"masked_sum: max abs err {ms_err} > {ms_tol}")
    rec_ms = {
        "name": "masked_sum", "shape": [n, d],
        "max_abs_err": ms_err, "tolerance": ms_tol,
        "ms": cuda_ms(lambda: uplink.masked_sum(x, slot, band, C, S), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum(x, slot, band, C, S), 2),
        # owned x entries read, band read, x_bar written, slot read
        "bound_ms": bound_ms(4 * (owned + 2 * d + n)),
    }

    h = torch.randn(n, d, generator=g, device=dev).mul_(0.01)
    xk, hk = x.clone(), h.clone()
    uplink.h_update(xk, hk, xbar, slot, band, C, S, scale, down=down)
    ref.h_update(x, h, xbar, slot, band, C, S, scale, down=down)
    torch.cuda.synchronize()
    hu_err = max(max_abs_err(xk, x), max_abs_err(hk, h))
    if hu_err != 0.0:
        raise AssertionError(f"h_update: max abs err {hu_err}, want 0")
    rec_hu = {
        "name": "h_update", "shape": [n, d], "max_abs_err": hu_err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.h_update(
            xk, hk, xbar, slot, band, C, S, scale, down=down), 5),
        "plain_ms": cuda_ms(lambda: ref.h_update(
            x, h, xbar, slot, band, C, S, scale, down=down), 2),
        # owned x read + owned h read and written, x_bar and band read,
        # the down rows of x written, slot and down read
        "bound_ms": bound_ms(4 * (3 * owned + 2 * d + n_down * d + 2 * n)),
    }
    return rec_ms, rec_hu


def check_local_step(spec, dev):
    """fused_local_step against its plain version on every leaf shape of a
    client row, timed at the largest leaf; returns its record."""
    from repro_torch.dist import comm_ws
    from repro_torch.kernels import ref
    from repro_torch.kernels.local_step import fused_local_step

    g = torch.Generator(device=dev).manual_seed(2)
    x, gr, h = (torch.randn(spec.d_total, generator=g, device=dev)
                for _ in range(3))
    xs, gs, hs = (comm_ws.leaf_views(t, spec) for t in (x, gr, h))
    err = 0.0
    for name in spec.names:
        got = fused_local_step(xs[name], gs[name], hs[name], GAMMA)
        want = ref.fused_local_step(xs[name], gs[name], hs[name], GAMMA)
        err = max(err, max_abs_err(got, want))
    if err != 0.0:
        raise AssertionError(f"fused_local_step: max abs err {err}, want 0")
    big = max(zip(spec.dims, spec.names))[1]
    xe, ge, he = xs[big], gs[big], hs[big]
    out = torch.empty_like(xe)
    return {
        "name": "fused_local_step", "shape": list(xe.shape),
        "max_abs_err": err, "tolerance": 0.0,
        "ms": cuda_ms(lambda: fused_local_step(xe, ge, he, GAMMA, out=out),
                      10),
        "plain_ms": cuda_ms(lambda: ref.fused_local_step(xe, ge, he, GAMMA),
                            5),
        # x, g, h read, x written
        "bound_ms": bound_ms(16 * xe.numel()),
    }


def check_reduced_round(dev):
    """One reduced-config round on the card against the same round on the
    CPU (plain versions), with the same schedule and batches injected."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, C, 2, 97)))
    cohort, perm = [0, 2, 3], [2, 0, 1]
    down = torch.tensor([True, True, False, True])
    d_total = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    # distinct client rows, the same on both sides
    noise = torch.from_numpy(
        0.01 * rng.normal(size=(N - 1, d_total)).astype(np.float32))
    out = {}
    for device in ("cpu", dev):
        state = tamuna_dp.init_state(cfg, tcfg, N, seed=0, device="cpu")
        state.x[1:] += noise
        state.x, state.h = state.x.to(device), state.h.to(device)
        local = tamuna_dp.make_local_step(cfg, tcfg)
        compact = tamuna_dp.gather_cohort(state, cohort)
        for t in range(toks.shape[0]):
            tk = toks[t].to(device)
            local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
        comm = tamuna_dp.make_comm_step(cfg, tcfg, N, device=device)
        state = comm(tamuna_dp.scatter_cohort(state, compact), cohort, perm,
                     down)
        out[str(device)] = (state.x.cpu(), state.h.cpu())
    (xc, hc), (xg, hg) = out["cpu"], out[str(dev)]
    err = max(max_abs_err(xc, xg), max_abs_err(hc, hg))
    print(f"[reduced] one round of {cfg.name} on the card vs the CPU: "
          f"max abs err {err:.3e} (tolerance 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"reduced round: card vs CPU err {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.configs import gemma2_2b
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import comm_ws, model_api, rounds, tamuna_dp
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = smi()
    print(f"[card] {card}")

    path, secs, log = _build.build()
    print(f"[build] {os.path.relpath(path, here)} in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    _build.load()

    cfg = dataclasses.replace(gemma2_2b.CONFIG, n_layers=2)
    print(f"[config] {cfg.name} at published widths (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, head_dim "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}); depth cut "
          f"{gemma2_2b.CONFIG.n_layers} -> {cfg.n_layers} layers, windows "
          f"{cfg.layer_windows()}")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P)
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    print(f"[config] d_total {spec.d_total} f32 per client row, n={N} "
          f"c={C} s={S}")

    rec_ms, rec_hu = check_uplink_kernels(spec, tcfg, dev)
    torch.cuda.empty_cache()
    rec_ls = check_local_step(spec, dev)
    torch.cuda.empty_cache()
    for rec in (rec_ms, rec_hu, rec_ls):
        print(f"[check] {rec['name']} {rec['shape']}: max abs err "
              f"{rec['max_abs_err']} (tolerance {rec['tolerance']}), "
              f"{rec['ms']:.3f} ms vs plain {rec['plain_ms']:.3f} ms, "
              f"bound {rec['bound_ms']:.3f} ms")
    check_reduced_round(dev)
    torch.cuda.empty_cache()

    # ---- the main path: 3 rounds of full-width 2-layer gemma2-2b --------
    state = tamuna_dp.init_state(cfg, tcfg, N, seed=0, device=dev)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                   n_clients=N), cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    state, rows = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=3,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=4)
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    for row in rows:
        print(f"[train] round {row['round']}: L={row['L']} loss "
              f"{row['loss']:.6f} wall {row['seconds']:.3f} s up_floats "
              f"{row['up_floats']:.0f} down_floats {row['down_floats']:.0f}")
    print(f"[train] launches {launches}")
    print(f"[train] max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"non-finite loss: {rows}")
    if not all(launches[k] > 0 for k in _build.KERNELS):
        raise AssertionError(f"a kernel was not launched: {launches}")
    hsum = max(float(state.h[:, a:a + (1 << 27)].sum(0).abs().max())
               for a in range(0, spec.d_total, 1 << 27))
    hmax = float(state.h.abs().max())
    ratio = hsum / hmax if hmax > 0 else math.inf
    print(f"[train] |sum_i h_i| / max|h| = {ratio:.3e} (limit 1e-4)")
    if not ratio <= 1e-4:
        raise AssertionError(f"sum_i h_i = 0 violated: ratio {ratio}")

    src = "src/repro_torch/kernels/csrc/tamuna_kernels.cu"
    replaces = {"masked_sum": "src/repro/kernels/uplink.py:55",
                "h_update": "src/repro/kernels/uplink.py:153",
                "fused_local_step": "src/repro/kernels/local_step.py:26"}
    kernels = []
    for rec in (rec_ms, rec_hu, rec_ls):
        kernels.append({
            "name": rec["name"], "route": "cuda", "source": src,
            "replaces": replaces[rec["name"]],
            "launches": launches[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": rec["shape"], "tolerance": rec["tolerance"],
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
