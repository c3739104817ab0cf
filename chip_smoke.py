#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, train.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package ``repro``, and in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels of ``src/repro_torch/kernels/csrc/`` with nvcc
   for sm_90a and prints the build time and ptxas' register report;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the paths below (gemma2-2b at published widths cut to 2
   layers, d_total = 745,558,272), timing both with CUDA events:
   ``masked_sum`` and ``h_update`` on an ``(n=4, d)`` f32 workspace with
   an idle row of NaN and a ragged tail; the local step on the largest
   leaf ``(256000, 2304)``; ``masked_sum(counts=True)``, ``robust_sum``
   (trimmed k=1 and median at s=3) and the covered ``h_update`` on an
   ``(n=5, d)`` workspace with a dropped row of NaN, owned +inf/-inf
   entries and tied values, the covered update with 3 of 4 members
   dropped so a quarter of the coordinates is uncovered;
4. runs one round of the reduced gemma2-2b config on the card and on the
   CPU with the same injected schedule and batches, and compares them:
   the fault-free round, and a round with a dropped member and the
   trimmed mean;
5. drives three paths of ``repro_torch.dist.rounds.run_rounds``, each for
   3 rounds of 2-layer full-width gemma2-2b (seq 128, 2 sequences per
   client, max_L 4) with the launch counts set to 0 just before and read
   just after:
   ``[train]``  the fault-free round, n=4 clients, cohort c=3, s=2;
   ``[faults]`` the survivor round, n=5, c=4, s=3, a ``CohortPlan``,
                25% uplink drops and 20% NaN payloads, quorum policy,
                quarantine of 2 rounds;
   ``[robust]`` the robust round, n=5, c=4, s=3, 20% drops, one
                sign-flipping Byzantine client, quorum, trimmed mean k=1
                behind the adaptive payload guard;
   each must have finite losses and launch every kernel of its path; the
   fault-free and survivor paths must keep sum_i h_i = 0.

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

# H100 SXM device-memory rate (NVIDIA data sheet), the bound of every
# kernel: they do O(1) operations per byte.
HBM_BYTES_PER_S = 3.35e12

N, C, S = 4, 3, 2  # clients, cohort, sparsity of the fault-free path
NF, CF, SF = 5, 4, 3  # the same for the survivor and robust paths
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
    """max |a - b| over same-shape tensors, equal values (infinities
    included) and NaN where both are NaN counted as equal, in column
    chunks so no full-size temporary is made; inf where only one side is
    NaN or the two infinities differ."""
    a2, b2 = a.reshape(-1), b.reshape(-1)
    err = 0.0
    for i in range(0, a2.numel(), chunk):
        x, y = a2[i:i + chunk], b2[i:i + chunk]
        if bool((x.isnan() ^ y.isnan()).any()):
            return math.inf
        same = (x == y) | (x.isnan() & y.isnan())
        d = (x - y).abs().masked_fill(same, 0.0)
        err = max(err, float(d.nan_to_num(nan=math.inf).max()))
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


def check_fault_kernels(spec, dev):
    """masked_sum(counts=True), robust_sum (trimmed k=1 and median) and the
    covered h_update against their plain versions on the ``(NF, d)``
    workspace of the survivor and robust paths; returns their records."""
    from repro_torch.dist import comm_ws
    from repro_torch.kernels import ref, uplink

    n, d = NF, spec.d_total
    g = torch.Generator(device=dev).manual_seed(3)
    band = comm_ws.cyclic_band(spec.dims, CF, SF, dev)
    # members 0-3 on template columns 1, -, 0, 3 (row 1 dropped, its
    # payload NaN), row 4 idle
    slot = torch.tensor([1, -1, 0, 3, -1], dtype=torch.int32, device=dev)
    x = torch.randn(n, d, generator=g, device=dev)
    x[1] = float("nan")
    x[0, ::1000] = float("inf")
    x[2, 500::1000] = float("-inf")
    x[3, ::7] = x[0, ::7]  # tied owner values
    owned = owned_entries(slot, band, CF, SF)
    print(f"[check] workspace ({n}, {d}) f32, slot {slot.tolist()}, "
          f"{owned} owned entries")
    # owned x entries read, band read, two (d,) outputs written, slot read
    uplink_bound = bound_ms(4 * (owned + 3 * d + n))

    num, cnt = uplink.masked_sum(x, slot, band, CF, SF, counts=True)
    num_p, cnt_p = ref.masked_sum_counts(x, slot, band, CF, SF)
    torch.cuda.synchronize()
    err = max(max_abs_err(num, num_p), max_abs_err(cnt, cnt_p))
    del num, cnt, num_p, cnt_p
    if err != 0.0:
        raise AssertionError(f"masked_sum_counts: max abs err {err}, want 0")
    recs = [{
        "name": "masked_sum_counts", "shape": [n, d], "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.masked_sum(
            x, slot, band, CF, SF, counts=True), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum_counts(
            x, slot, band, CF, SF), 2),
        "bound_ms": uplink_bound,
    }]

    rb = {}
    for kind, k in (("trimmed", 1), ("median", 0)):
        bar, cnt = uplink.robust_sum(x, slot, band, CF, SF, kind=kind, k=k)
        bar_p, cnt_p = ref.robust_sum(x, slot, band, CF, SF, kind, k)
        torch.cuda.synchronize()
        e = max(max_abs_err(bar, bar_p), max_abs_err(cnt, cnt_p))
        print(f"[check] robust_sum {kind} k={k}: max abs err {e}, "
              f"{int(bar.isinf().sum())} inf and {int(bar.isnan().sum())} "
              f"NaN outputs")
        del bar, cnt, bar_p, cnt_p
        if e != 0.0:
            raise AssertionError(f"robust_sum {kind}: max abs err {e}, "
                                 "want 0")
        rb[kind] = (e, cuda_ms(lambda: uplink.robust_sum(
            x, slot, band, CF, SF, kind=kind, k=k), 5),
            cuda_ms(lambda: ref.robust_sum(x, slot, band, CF, SF, kind, k),
                    2))
    recs.append({
        "name": "robust_sum", "shape": [n, d],
        "max_abs_err": max(v[0] for v in rb.values()), "tolerance": 0.0,
        # the trimmed mean is the path's combiner; the median's times
        # ride along
        "ms": rb["trimmed"][1], "plain_ms": rb["trimmed"][2],
        "median_ms": rb["median"][1], "median_plain_ms": rb["median"][2],
        "bound_ms": uplink_bound,
    })

    # 3 of the 4 members dropped: a quarter of the coordinates uncovered
    slot_c = torch.tensor([1, -1, -1, -1, -1], dtype=torch.int32,
                          device=dev)
    down = torch.tensor([1, 0, 1, 0, 1], dtype=torch.int32, device=dev)
    x_bar, cnt = uplink.masked_sum(x, slot_c, band, CF, SF, counts=True)
    covered = cnt > 0
    x_bar.div_(cnt.clamp_(min=1.0))
    del cnt
    n_cov = int(covered.sum())
    owned_c = owned_entries(slot_c, band, CF, SF)
    n_down = int(down.sum())
    print(f"[check] covered h_update: slot {slot_c.tolist()}, down "
          f"{down.tolist()}, {d - n_cov} of {d} coordinates uncovered")
    scale = 0.37
    h = torch.randn(n, d, generator=g, device=dev).mul_(0.01)
    xk, hk = x.clone(), h.clone()
    uplink.h_update(xk, hk, x_bar, slot_c, band, CF, SF, scale, down=down,
                    covered=covered)
    ref.h_update(x, h, x_bar, slot_c, band, CF, SF, scale, down=down,
                 covered=covered)
    torch.cuda.synchronize()
    err = max(max_abs_err(xk, x), max_abs_err(hk, h))
    if err != 0.0:
        raise AssertionError(f"h_update_covered: max abs err {err}, want 0")
    recs.append({
        "name": "h_update_covered", "shape": [n, d], "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.h_update(
            xk, hk, x_bar, slot_c, band, CF, SF, scale, down=down,
            covered=covered), 5),
        "plain_ms": cuda_ms(lambda: ref.h_update(
            x, h, x_bar, slot_c, band, CF, SF, scale, down=down,
            covered=covered), 2),
        # the gate read; on covered coordinates band and x_bar read and
        # the down rows of x written; owned x read, owned h read and
        # written; slot and down read
        "bound_ms": bound_ms(d + 4 * (2 * n_cov + n_down * n_cov
                                      + 3 * owned_c + 2 * n)),
    })
    return recs


def check_reduced_round(dev, n, c, s, cohort, perm, down, arrived=None,
                        **robust):
    """One reduced-config round on the card against the same round on the
    CPU (plain versions), with the same schedule, batches and (if given)
    arrived rows injected."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P, **robust)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, c, 2, 97)))
    down = torch.tensor(down)
    d_total = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    # distinct client rows, the same on both sides
    noise = torch.from_numpy(
        0.01 * rng.normal(size=(n - 1, d_total)).astype(np.float32))
    kw = {} if arrived is None else {"arrived": np.asarray(arrived)}
    out = {}
    for device in ("cpu", dev):
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
        state.x[1:] += noise
        state.x, state.h = state.x.to(device), state.h.to(device)
        local = tamuna_dp.make_local_step(cfg, tcfg)
        compact = tamuna_dp.gather_cohort(state, cohort)
        for t in range(toks.shape[0]):
            tk = toks[t].to(device)
            local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
        comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=device)
        state = comm(tamuna_dp.scatter_cohort(state, compact), cohort, perm,
                     down, **kw)
        out[str(device)] = (state.x.cpu(), state.h.cpu())
    (xc, hc), (xg, hg) = out["cpu"], out[str(dev)]
    err = max(max_abs_err(xc, xg), max_abs_err(hc, hg))
    print(f"[reduced] one round of {cfg.name} (n={n} c={c} s={s} "
          f"{tcfg.robust_agg}, arrived {arrived}) on the card vs the CPU: "
          f"max abs err {err:.3e} (tolerance 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"reduced round: card vs CPU err {err}")


def h_sum_ratio(h, d: int) -> float:
    """|sum_i h_i| / max|h| over the ``(n, d)`` control variates, in
    column chunks."""
    hsum = max(float(h[:, a:a + (1 << 27)].sum(0).abs().max())
               for a in range(0, d, 1 << 27))
    hmax = float(h.abs().max())
    return hsum / hmax if hmax > 0 else math.inf


def run_path(tag, cfg, tcfg, n, dev, need, check_h_sum, **kw):
    """Drive ``run_rounds`` for 3 rounds of ``cfg`` at ``n`` clients with
    the launch counts set to 0 just before and read just after; check
    finite losses, a launch of every kernel in ``need`` and, if asked,
    sum_i h_i = 0.  Returns the launch counts."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import comm_ws, model_api, rounds, tamuna_dp
    from repro_torch.kernels import _build

    d = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    desc = [f"n={n} c={tcfg.c} s={tcfg.s} robust_agg={tcfg.robust_agg} "
            f"trim_k={tcfg.trim_k}"]
    if "faults" in kw:
        fp = kw["faults"]
        desc.append(f"{fp.model} byzantine clients "
                    f"{np.flatnonzero(fp.byzantine).tolist()}")
    desc += [f"{k}={v}" for k, v in kw.items()
             if k not in ("faults", "plan")]
    if "plan" in kw:
        desc.append("cohorts from CohortPlan(0, n, c)")
    print(f"[{tag}] " + ", ".join(desc))
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=dev)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=128, per_client_batch=2, vocab=512, seed=0,
                   n_clients=n), cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    state, rows = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=3,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=4, **kw)
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    fault_keys = ("arrivals", "corrupted", "retries", "backoff_s",
                  "quorum_miss", "round_latency_s")
    for row in rows:
        extra = " ".join(f"{k} {row[k]:.6g}" for k in fault_keys if k in row)
        print(f"[{tag}] round {row['round']}: L={row['L']} loss "
              f"{row['loss']:.6f} wall {row['seconds']:.3f} s up_floats "
              f"{row['up_floats']:.0f} down_floats {row['down_floats']:.0f}"
              + (f" {extra}" if extra else ""))
    print(f"[{tag}] launches {launches}")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"[{tag}] non-finite loss: {rows}")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"[{tag}] a kernel of {need} was not "
                             f"launched: {launches}")
    if check_h_sum:
        ratio = h_sum_ratio(state.h, d)
        print(f"[{tag}] |sum_i h_i| / max|h| = {ratio:.3e} (limit 1e-4)")
        if not ratio <= 1e-4:
            raise AssertionError(f"[{tag}] sum_i h_i = 0 violated: ratio "
                                 f"{ratio}")
    del state, pipe
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import cohort, comm_ws, faults, model_api, tamuna_dp
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
    print(f"[config] d_total {spec.d_total} f32 per client row")

    recs = list(check_uplink_kernels(spec, tcfg, dev))
    torch.cuda.empty_cache()
    recs.append(check_local_step(spec, dev))
    torch.cuda.empty_cache()
    recs += check_fault_kernels(spec, dev)
    torch.cuda.empty_cache()
    for rec in recs:
        print(f"[check] {rec['name']} {rec['shape']}: max abs err "
              f"{rec['max_abs_err']} (tolerance {rec['tolerance']}), "
              f"{rec['ms']:.3f} ms vs plain {rec['plain_ms']:.3f} ms, "
              f"bound {rec['bound_ms']:.3f} ms")
    check_reduced_round(dev, N, C, S, [0, 2, 3], [2, 0, 1],
                        [True, True, False, True])
    # the faulted round: member 1 dropped, the trimmed mean
    check_reduced_round(dev, NF, CF, SF, [0, 1, 3, 4], [3, 0, 2, 1],
                        [True, True, True, False, True],
                        arrived=[True, False, False, True, True],
                        robust_agg="trimmed", trim_k=1)
    torch.cuda.empty_cache()

    # ---- the paths: 3 rounds of full-width 2-layer gemma2-2b each --------
    by_path = {}
    by_path["train"] = run_path(
        "train", cfg, tcfg, N, dev,
        need=("masked_sum", "h_update", "fused_local_step"),
        check_h_sum=True)
    tcfg_f = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P)
    by_path["faults"] = run_path(
        "faults", cfg, tcfg_f, NF, dev,
        need=("masked_sum_counts", "h_update_covered", "fused_local_step"),
        check_h_sum=True,
        plan=cohort.CohortPlan(0, NF, CF),
        faults=faults.FaultPlan(seed=0, n=NF, p_drop=0.25, p_corrupt=0.2,
                                corrupt_mode="nan"),
        policy="quorum", quarantine_rounds=2)
    # a robust combine breaks sum_i h_i = 0 by design: not checked
    tcfg_r = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P,
                                        robust_agg="trimmed", trim_k=1)
    by_path["robust"] = run_path(
        "robust", cfg, tcfg_r, NF, dev,
        need=("robust_sum", "h_update_covered", "fused_local_step"),
        check_h_sum=False,
        faults=faults.FaultPlan(seed=0, n=NF, p_drop=0.2,
                                adversary="sign_flip", f_byz=0.2),
        policy="quorum")

    src = "src/repro_torch/kernels/csrc/tamuna_kernels.cu"
    # each kernel's body in the reference and the path whose launches the
    # record reports
    replaces = {
        "masked_sum": ("src/repro/kernels/uplink.py:55", "train"),
        "masked_sum_counts": ("src/repro/kernels/uplink.py:65", "faults"),
        "robust_sum": ("src/repro/kernels/uplink.py:106", "robust"),
        "h_update": ("src/repro/kernels/uplink.py:153", "train"),
        "h_update_covered": ("src/repro/kernels/uplink.py:167", "faults"),
        "fused_local_step": ("src/repro/kernels/local_step.py:26", "train"),
    }
    kernels = []
    for rec in recs:
        body, path_name = replaces[rec["name"]]
        kernels.append({
            "name": rec["name"], "route": "cuda", "source": src,
            "replaces": body,
            "launches": by_path[path_name][rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": rec["shape"], "tolerance": rec["tolerance"],
            "path": path_name,
            "launches_by_path": {p: by_path[p][rec["name"]]
                                 for p in by_path},
            **{k: rec[k] for k in ("median_ms", "median_plain_ms")
               if k in rec},
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
