#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, train,
run the paper's convex TAMUNA, and serve.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package ``repro``, and in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels of ``src/repro_torch/kernels/csrc/`` with nvcc
   for sm_90a and prints the build time and ptxas' register and spill
   report;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the paths below (gemma2-2b at published widths cut to 2
   layers, d_total = 745,558,272), timing both with CUDA events:
   ``masked_sum`` and ``h_update`` on an ``(n=4, d)`` f32 workspace with
   an idle row of NaN and a ragged tail; the local step on the largest
   leaf ``(256000, 2304)``; ``masked_sum(counts=True)``, ``robust_sum``
   (trimmed k=1 and median at s=3) and the covered ``h_update`` on an
   ``(n=5, d)`` workspace with a dropped row of NaN, owned +inf/-inf
   entries and tied values, the covered update with 3 of 4 members
   dropped so a quarter of the coordinates is uncovered; the wire's
   kernels: ``masked_sum_dequant`` on ``(4, d)`` int8 codes and its
   counts form on ``(5, d)`` with a dropped row of NaN scales and
   NaN-poisoned chunks in an owned row, ``masked_sum`` (both forms) over
   f16 and bf16 lanes, the f16 form also at the width of ``[wire]``'s own
   f16 group (the small leaves), and the
   quantizer ``wire_quantize`` in int8, int4 and DownCom modes on rows
   with +inf, -inf, NaN and an all-zero chunk, each form with its share of
   its bound;
   every UpCom (``masked_sum`` in both forms and every lane,
   ``robust_sum``, ``masked_sum_dequant``) with its share of the byte bound
   and of the sector floor (the owning rows' entries in whole 32-byte
   sectors);
   the convex core's ``compress`` in f64 at the convex paths' shapes
   ``(100, 20958)`` and ``(1000, 20958)`` with their round-0 permutations
   (and the kernel body's own time there, from ``torch.profiler`` or a
   replayed CUDA graph, without the wrapper's host time),
   in f32 on the ``(4, d)`` workspace (slot ``[1, -1, 0, 2]``, c=3, s=2,
   an idle row of NaN), and in its 1-D form at ``(20958,)`` f64 and
   ``(d,)`` f32, each bitwise;
4. runs one round of the reduced gemma2-2b config on the card and on the
   CPU (one intra-op thread) with the same injected schedule and batches,
   and compares them:
   the fault-free round, a round with a dropped member and the trimmed
   mean, and an int8 ``wire_down`` round with a dropped member and the
   trimmed mean whose comm step runs on both devices from the same
   trained state and must agree bitwise;
5. drives five paths of ``repro_torch.dist.rounds.run_rounds``, each for
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
   ``[wire]``   the quantized wire, n=4, c=3, s=2, ``auto`` (the norm
                leaves as f16 lanes, the rest int8 codes) with the DownCom
                quantized too; prints the per-client wire bytes;
   ``[wire_faults]`` the survivor round on the int8 wire, n=5, c=4, s=3,
                a ``CohortPlan``, 25% uplink drops, quorum;
   each must have finite losses and launch every kernel of its path; the
   fault-free and survivor paths on the f32 wire must keep sum_i h_i = 0
   (printed, not checked, on the others: a robust combine breaks it by
   design, a quantized numerator by its rounding);
6. builds the paper's Fig. 3 problem at paper scale
   (``benchmarks/paper_fig3.py --paper-scale``: real-sim-like l2-logistic
   regression, n=1000 clients, d=20958, 4 samples each, kappa=1e4, seed
   0) in float64 on the card, prints its set-up time (data, L, Newton),
   holds the first 5 rounds of ``repro_torch.core.tamuna.run`` on the
   card against the CPU (1e-10 relative, x_bar and h), and drives two
   paths of ``run`` with the tuned config (s=2, p=0.2236), launch counts
   set to 0 just before and read just after:
   ``[convex]``      the 10% cohort, c=100, 8000 rounds (Fig. 3's count);
   ``[convex_full]`` full participation, c=1000, 1500 rounds;
   each prints its records (suboptimality, Lyapunov function), the round
   time, peak memory, the launches and Theorem 1's tau beside the
   measured Lyapunov rate, and must keep sum_i h_i = 0 (1e-10 of
   max|h|), end with a finite suboptimality below its start and launch
   ``compress_f64`` exactly twice per round and nothing else;
7. holds ``decode_attention`` against its plain version on the card
   (bf16: 16-key K/V tiles through shared memory, logits and PV on the
   tensor cores; f32: one key per warp per step):
   bf16 queries and cache at gemma2-2b's heads (8, 8, 256) over a
   (8, 32768, 4, 256) cache at pos 0, 4095 and 30000 with the 4096 window
   and globally, softcap 50, within one bf16 ulp, and at the serving
   paths' shapes; f32 queries on f32 and bf16 caches at the reduced
   config's heads within 2e-5; the kernel untouched by NaN in every cache
   row outside the visible keys; timing the kernel, the plain version and
   ``scaled_dot_product_attention`` (softcap off) beside the bound;
8. serves, launch counts set to 0 just before each path and read just
   after, through ``repro_torch.launch.serve.run``:
   ``[serve_reduced]`` the reduced config (f32) past its window of 64, on
                 an f32 and a bf16 cache, card (kernel) vs CPU (plain
                 attention): last logits within 1e-4, greedy tokens equal;
   ``[serve]``   gemma2-2b at published widths and full depth (26
                 layers), batch 8, prompt 448 + 64 generated, bf16: ms per
                 step, tok/s, peak memory, a profiled step; 26 x 512
                 launches, no plain attention, finite logits;
   ``[serve_long]`` two full-width layers past the 4096 window, batch 4,
                 prompt 4544 + 64: the launches, and the last step rerun
                 from the same cache with plain attention.

It takes no options and runs every phase.  ``reduced_round_diag.py``
runs the first reduced round's card, CPU and float64 evaluations in fresh
processes.

Any failure raises and exits non-zero.  The last three lines of standard
output are the kernels' JSON record, the card's name and power limit, and
the device JSON record.

It exits non-zero without a result when no CUDA device is present, and
when it stands in a directory without the rest of the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM device-memory rate and dense peaks (NVIDIA data sheet): the
# training kernels do O(1) operations per byte and are bound by bytes;
# decode attention's bound takes the larger of its bytes and operations
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

N, C, S = 4, 3, 2  # clients, cohort, sparsity of the fault-free path
NF, CF, SF = 5, 4, 3  # the same for the survivor and robust paths
GAMMA, P = 0.05, 0.34
# the convex paths: paper Fig. 3 at paper scale (benchmarks/paper_fig3.py
# --paper-scale), real-sim-like logistic regression, and their rounds
CONVEX = dict(n=1000, d=20958, samples_per_client=4, kappa=1e4, seed=0)
CONVEX_ROUNDS = {"convex": 8000, "convex_full": 1500}
# intra-op threads of the CPU side of the reduced rounds
REDUCED_CPU_THREADS = 1
# decode attention: gemma2-2b's heads over a 32k cache (b 8), and the
# reduced config's heads over a 4k cache for the f32 instantiations
DECODE_FULL = dict(b=8, h=8, kvh=4, hd=256, S=32768)
DECODE_F32 = dict(b=8, h=4, kvh=2, hd=64, S=4096)
# the serving paths: the reduced config past its window of 64; full-depth
# gemma2-2b at 512 rows; two full-width layers past the 4096 window
SERVE_REDUCED = dict(batch=4, prompt_len=72, gen_len=8)
SERVE = dict(batch=8, prompt_len=448, gen_len=64)
SERVE_LONG = dict(batch=4, prompt_len=4544, gen_len=64)


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


def kernel_only_ms(fn, name: str, reps: int = 100):
    """The device time of kernel ``name`` per call of ``fn``, without the
    wrapper's host time (which CUDA events around back-to-back calls of a
    small kernel measure instead): ``torch.profiler``'s device time over
    ``reps`` calls, or, where the profiler records no device time, a CUDA
    graph of ``reps`` captured calls replayed under CUDA events.  Returns
    ``(ms, "profiler" or "graph")``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, calls = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total_us += (getattr(ev, "device_time_total", None)
                         or getattr(ev, "cuda_time_total", 0.0))
            calls += ev.count
    if calls and total_us > 0:
        return total_us / calls / 1e3, "profiler"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps, "graph"


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


def owned_sectors(slot, band, m: int, s: int, width: int,
                  chunk: int = 1 << 26) -> int:
    """How many 32-byte sectors of the rows' ``width``-byte entries hold an
    owned entry: what a kernel that reads whole sectors moves, beside
    ``owned_entries``' count of the owned entries alone.  Rows start on the
    sector grid (``d * width`` a multiple of 32 at full width)."""
    per = 32 // width
    d = band.numel()
    total = 0
    for sl in slot.tolist():
        if not 0 <= sl < m:
            continue
        for a in range(0, d, chunk):
            own = (sl + band[a:a + chunk]) % m < s
            pad = -own.numel() % per
            if pad:
                own = torch.nn.functional.pad(own, (0, pad))
            total += int(own.view(-1, per).any(dim=1).sum())
    return total


def with_floor(rec: dict) -> dict:
    """Adds a record's shares of its byte bound and of its sector floor
    (what a kernel that reads whole 32-byte sectors must move) and prints
    them; returns the record."""
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["share_of_floor"] = rec["sector_floor_ms"] / rec["ms"]
    print(f"[check] {rec['name']}: {rec['ms']:.3f} ms, "
          f"{rec['share_of_bound']:.1%} of the bound "
          f"({rec['bound_ms']:.3f} ms), {rec['share_of_floor']:.1%} of the "
          f"sector floor ({rec['sector_floor_ms']:.3f} ms; the layout's "
          f"ceiling {rec['bound_ms'] / rec['sector_floor_ms']:.1%} of the "
          f"bound)")
    return rec


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


def up_bytes(spec, c: int, s: int, policy: str) -> float:
    """Per-client UpCom wire bytes of one round (``make_comm_step``'s
    accounting) without building a comm step."""
    from repro_torch.core import masks
    from repro_torch.dist import wire

    return sum(wire.leaf_up_bytes(masks.column_nnz(D, c, s), D, 1,
                                  wire.resolve_kind(D, policy))
               for D in spec.dims)


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
    rec_ms = with_floor({
        "name": "masked_sum", "shape": [n, d],
        "max_abs_err": ms_err, "tolerance": ms_tol,
        "ms": cuda_ms(lambda: uplink.masked_sum(x, slot, band, C, S), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum(x, slot, band, C, S), 2),
        # owned x entries read, band read, x_bar written, slot read
        "bound_ms": bound_ms(4 * (owned + 2 * d + n)),
        # the same with the owning rows' entries in whole 32-byte sectors
        "sector_floor_ms": bound_ms(
            32 * owned_sectors(slot, band, C, S, 4) + 4 * (2 * d + n)),
    })

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
    # the same with the owning rows' entries in whole 32-byte sectors
    uplink_floor = bound_ms(32 * owned_sectors(slot, band, CF, SF, 4)
                            + 4 * (3 * d + n))

    num, cnt = uplink.masked_sum(x, slot, band, CF, SF, counts=True)
    num_p, cnt_p = ref.masked_sum_counts(x, slot, band, CF, SF)
    torch.cuda.synchronize()
    err = max(max_abs_err(num, num_p), max_abs_err(cnt, cnt_p))
    del num, cnt, num_p, cnt_p
    if err != 0.0:
        raise AssertionError(f"masked_sum_counts: max abs err {err}, want 0")
    recs = [with_floor({
        "name": "masked_sum_counts", "shape": [n, d], "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.masked_sum(
            x, slot, band, CF, SF, counts=True), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum_counts(
            x, slot, band, CF, SF), 2),
        "bound_ms": uplink_bound, "sector_floor_ms": uplink_floor,
    })]

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
    recs.append(with_floor({
        "name": "robust_sum", "shape": [n, d],
        "max_abs_err": max(v[0] for v in rb.values()), "tolerance": 0.0,
        # the trimmed mean is the path's combiner; the median's times
        # ride along
        "ms": rb["trimmed"][1], "plain_ms": rb["trimmed"][2],
        "median_ms": rb["median"][1], "median_plain_ms": rb["median"][2],
        "bound_ms": uplink_bound, "sector_floor_ms": uplink_floor,
    }))

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


def check_wire_kernels(spec, dev):
    """The wire's kernels against their plain versions on full-width
    workspaces: ``masked_sum_dequant`` (both forms), ``masked_sum`` over
    f16 and bf16 lanes (both forms) and ``wire_quantize`` (int8, int4 and
    the DownCom); returns their records."""
    from repro_torch.dist import comm_ws, wire
    from repro_torch.kernels import ref, uplink, wire_pack

    d = spec.d_total
    g = torch.Generator(device=dev).manual_seed(4)
    leaves = [(i, o, D) for i, (o, D) in enumerate(zip(spec.offsets,
                                                       spec.dims))]
    # the leaf starts as host integers (the wrapper's form) and as a
    # tensor on the card (the plain version's)
    lo = tuple([0] + [o + D for _, o, D in leaves])
    lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
    nc = sum(wire.n_chunks(D) for D in spec.dims)
    recs = []

    # -- masked_sum_dequant, (4, d), the [wire] path's shape --------------
    band = comm_ws.cyclic_band(spec.dims, C, S, dev)
    slot = torch.tensor([1, -1, 0, 2], dtype=torch.int32, device=dev)
    codes = torch.randint(-127, 128, (N, d), generator=g, device=dev,
                          dtype=torch.int8)
    scales = torch.rand(N, nc, generator=g, device=dev).mul_(0.01)
    scales[1] = float("nan")  # the idle row's chunks never leak
    owned = owned_entries(slot, band, C, S)
    sectors = owned_sectors(slot, band, C, S, 1)
    bar = uplink.masked_sum_dequant(codes, scales, lo, slot, band, C, S)
    bar_p = ref.masked_sum_dequant(codes, scales, lo_t, slot, band, C, S)
    torch.cuda.synchronize()
    err = max_abs_err(bar, bar_p)
    if not bool(bar.isfinite().all()) or err != 0.0:
        raise AssertionError(f"masked_sum_dequant: max abs err {err}")
    del bar, bar_p
    recs.append(with_floor({
        "name": "masked_sum_dequant", "shape": [N, d], "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.masked_sum_dequant(
            codes, scales, lo, slot, band, C, S), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum_dequant(
            codes, scales, lo_t, slot, band, C, S), 2),
        # owned codes (1 B) read, the owning rows' scales, band read,
        # x_bar written, the leaf tables and slot read
        "bound_ms": bound_ms(owned + 4 * (3 * nc + 2 * d + 2 * len(leaves)
                                          + N)),
        # the same with the owning rows' codes in whole 32-byte sectors:
        # the least a kernel that reads sectors can move
        "sector_floor_ms": bound_ms(32 * sectors + 4 * (
            3 * nc + 2 * d + 2 * len(leaves) + N)),
    }))
    del codes, scales, band

    # -- masked_sum_dequant(counts=True), (5, d), the [wire_faults] shape --
    band = comm_ws.cyclic_band(spec.dims, CF, SF, dev)
    slot = torch.tensor([1, -1, 0, 3, -1], dtype=torch.int32, device=dev)
    codes = torch.randint(-127, 128, (NF, d), generator=g, device=dev,
                          dtype=torch.int8)
    scales = torch.rand(NF, nc, generator=g, device=dev).mul_(0.01)
    scales[1] = float("nan")  # the dropped row
    scales[0, ::1000] = float("nan")  # poisoned chunks of an owned row
    owned = owned_entries(slot, band, CF, SF)
    sectors = owned_sectors(slot, band, CF, SF, 1)
    num, cnt = uplink.masked_sum_dequant(codes, scales, lo, slot, band, CF,
                                         SF, counts=True)
    num_p, cnt_p = ref.masked_sum_dequant(codes, scales, lo_t, slot, band,
                                          CF, SF, counts=True)
    torch.cuda.synchronize()
    err = max(max_abs_err(num, num_p), max_abs_err(cnt, cnt_p))
    n_nan = int(num.isnan().sum())
    print(f"[check] masked_sum_dequant_counts: {n_nan} NaN outputs from "
          f"{int(scales[0].isnan().sum())} poisoned chunks of row 0")
    if err != 0.0 or n_nan == 0:
        raise AssertionError(f"masked_sum_dequant_counts: max abs err {err},"
                             f" {n_nan} NaN")
    del num, cnt, num_p, cnt_p
    recs.append(with_floor({
        "name": "masked_sum_dequant_counts", "shape": [NF, d],
        "max_abs_err": err, "tolerance": 0.0,
        "ms": cuda_ms(lambda: uplink.masked_sum_dequant(
            codes, scales, lo, slot, band, CF, SF, counts=True), 5),
        "plain_ms": cuda_ms(lambda: ref.masked_sum_dequant(
            codes, scales, lo_t, slot, band, CF, SF, counts=True), 2),
        # owned codes read, 3 owning rows' scales, band read, num and cnt
        # written, the leaf tables and slot read
        "bound_ms": bound_ms(owned + 4 * (3 * nc + 3 * d + 2 * len(leaves)
                                          + NF)),
        "sector_floor_ms": bound_ms(32 * sectors + 4 * (
            3 * nc + 3 * d + 2 * len(leaves) + NF)),
    }))
    del codes, scales

    # -- masked_sum over f16 and bf16 lanes, (4, d) -------------------------
    band = comm_ws.cyclic_band(spec.dims, C, S, dev)
    slot = torch.tensor([1, -1, 0, 2], dtype=torch.int32, device=dev)
    owned = owned_entries(slot, band, C, S)
    sectors = owned_sectors(slot, band, C, S, 2)
    for lane, tag in ((torch.float16, "f16"), (torch.bfloat16, "bf16")):
        x = torch.randn(N, d, generator=g, device=dev).to(lane)
        x[1] = float("nan")
        errs = []
        for counts in (False, True):
            got = uplink.masked_sum(x, slot, band, C, S, counts=counts)
            want = (ref.masked_sum_counts(x, slot, band, C, S) if counts
                    else ref.masked_sum(x, slot, band, C, S))
            torch.cuda.synchronize()
            got = got if counts else (got,)
            want = want if counts else (want,)
            errs += [max_abs_err(a, b) for a, b in zip(got, want)]
            del got, want
        err = max(errs)
        if err != 0.0:
            raise AssertionError(f"masked_sum {tag} lanes: max abs err {err}")
        recs.append(with_floor({
            "name": f"masked_sum_{tag}", "shape": [N, d],
            "max_abs_err": err, "tolerance": 0.0,
            "ms": cuda_ms(lambda: uplink.masked_sum(x, slot, band, C, S), 5),
            "plain_ms": cuda_ms(lambda: ref.masked_sum(x, slot, band, C, S),
                                2),
            "counts_ms": cuda_ms(lambda: uplink.masked_sum(
                x, slot, band, C, S, counts=True), 5),
            "counts_plain_ms": cuda_ms(lambda: ref.masked_sum_counts(
                x, slot, band, C, S), 2),
            # owned lanes (2 B) read, band read, x_bar written, slot read
            "bound_ms": bound_ms(2 * owned + 4 * (2 * d + N)),
            "sector_floor_ms": bound_ms(32 * sectors + 4 * (2 * d + N)),
        }))
        del x
    del band

    # -- masked_sum over f16 lanes at the width of [wire]'s f16 group -------
    # (the auto policy's small leaves; the width the path runs)
    gdims = [D for D in spec.dims if wire.resolve_kind(D, "auto") == "f16"]
    dg = sum(gdims)
    band = comm_ws.cyclic_band(gdims, C, S, dev)
    x = torch.randn(N, dg, generator=g, device=dev).half()
    x[1] = float("nan")
    got = uplink.masked_sum(x, slot, band, C, S)
    want = ref.masked_sum(x, slot, band, C, S)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"masked_sum f16 lanes at [wire]'s group width "
                             f"{dg}: max abs err {err}")
    f16 = next(r for r in recs if r["name"] == "masked_sum_f16")
    f16.update({
        "wire_shape": [N, dg], "wire_max_abs_err": err,
        "wire_ms": cuda_ms(lambda: uplink.masked_sum(x, slot, band, C, S),
                           200),
        "wire_plain_ms": cuda_ms(lambda: ref.masked_sum(x, slot, band, C, S),
                                 20),
        "wire_bound_ms": bound_ms(2 * owned_entries(slot, band, C, S)
                                  + 4 * (2 * dg + N)),
    })
    print(f"[check] masked_sum_f16 at [wire]'s f16 group ({len(gdims)} "
          f"leaves, {dg} columns): {f16['wire_ms']:.4f} ms, plain "
          f"{f16['wire_plain_ms']:.4f} ms, bound {f16['wire_bound_ms']:.4f} "
          f"ms")
    del x, got, want, band

    # -- wire_quantize: int8, int4 (UpCom) and the DownCom -----------------
    x = torch.randn(N, d, generator=g, device=dev)
    x[0, ::1000] = float("inf")
    x[2, 500::1000] = float("-inf")
    x[3, 7::999_983] = float("nan")
    x[1, 256:512] = 0.0  # an all-zero chunk of the first leaf
    q = {}
    for kind in ("int8", "int4"):
        codes, scales = wire_pack.pack_int(x, leaves, kind, 0x5EED)
        codes_p, scales_p = ref.wire_pack(x, leaves, kind, 0x5EED)
        torch.cuda.synchronize()
        err = max(max_abs_err(codes, codes_p),
                  max_abs_err(scales, scales_p))
        n_bad = int(scales.isnan().sum())
        if err != 0.0 or n_bad == 0:
            raise AssertionError(f"wire_quantize {kind}: max abs err {err}, "
                                 f"{n_bad} poisoned chunks")
        del codes, scales, codes_p, scales_p
        q[kind] = (err, cuda_ms(lambda: wire_pack.pack_int(
            x, leaves, kind, 0x5EED), 5), cuda_ms(lambda: ref.wire_pack(
                x, leaves, kind, 0x5EED), 2), n_bad)
    row = x[0].clone()
    row[3::1000] = float("nan")
    row[512:768] = 0.0  # an all-zero chunk
    got, want = row.clone(), row.clone()
    wire_pack.quantize_down(got, leaves, "int8", 0x5EED)
    ref.wire_down(want, leaves, "int8", 0x5EED)
    torch.cuda.synchronize()
    err_down = max_abs_err(got, want)
    if err_down != 0.0 or not bool(torch.equal(got.isinf(), row.isinf())):
        raise AssertionError(f"wire_quantize DownCom: max abs err "
                             f"{err_down}")
    down_ms = cuda_ms(lambda: wire_pack.quantize_down(
        got, leaves, "int8", 0x5EED), 5)
    down_plain_ms = cuda_ms(lambda: ref.wire_down(
        want, leaves, "int8", 0x5EED), 2)
    del got, want, row, x
    print(f"[check] wire_quantize: {q['int8'][3]} (int8) and {q['int4'][3]} "
          f"(int4) NaN-poisoned chunk scales of {N * nc}")
    # x read, the codes and the scales written, the leaf tables read
    up_bound = bound_ms(5 * N * d + 4 * N * nc + 40 * len(leaves))
    # the DownCom: x_bar read and written in place, the leaf tables read
    down_bound = bound_ms(8 * d + 40 * len(leaves))
    for form, ms, bound in (("int8", q["int8"][1], up_bound),
                            ("int4", q["int4"][1], up_bound),
                            ("DownCom", down_ms, down_bound)):
        print(f"[check] wire_quantize {form}: {ms:.3f} ms, "
              f"{bound / ms:.1%} of the bound ({bound:.3f} ms)")
    recs.append({
        "name": "wire_quantize", "shape": [N, d],
        "max_abs_err": max(q["int8"][0], q["int4"][0], err_down),
        "tolerance": 0.0,
        # the [wire] paths' UpCom form, int8; int4 and the DownCom ride
        # along
        "ms": q["int8"][1], "plain_ms": q["int8"][2],
        "int4_ms": q["int4"][1], "int4_plain_ms": q["int4"][2],
        "down_ms": down_ms, "down_plain_ms": down_plain_ms,
        "bound_ms": up_bound, "down_bound_ms": down_bound,
    })
    return recs


def check_reduced_wire_round(dev):
    """One reduced-config round on the int8 wire with the DownCom
    quantized, a dropped member and the trimmed mean: the local steps on
    the card against the CPU (1e-5), then the comm step on both devices
    from the CPU's trained state, which must agree bitwise (a last-bit
    difference in a trained coordinate may move its stochastic rounding
    by a level, so the two steps are held apart)."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    cfg = gemma2_2b.REDUCED
    n, cohort, perm = NF, [0, 1, 3, 4], [3, 0, 2, 1]
    tcfg = tamuna_dp.DistTamunaConfig(
        gamma=GAMMA, c=CF, s=SF, p=P, wire_precision="int8", wire_down=True,
        robust_agg="trimmed", trim_k=1)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, CF, 2, 97)))
    d_total = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    noise = torch.from_numpy(
        0.01 * rng.normal(size=(n - 1, d_total)).astype(np.float32))
    trained = {}
    for device in ("cpu", dev):
        state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
        state.x[1:] += noise
        state.x, state.h = state.x.to(device), state.h.to(device)
        local = tamuna_dp.make_local_step(cfg, tcfg)
        compact = tamuna_dp.gather_cohort(state, cohort)
        for t in range(toks.shape[0]):
            tk = toks[t].to(device)
            local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
        trained[str(device)] = state
    x_cpu = trained["cpu"].x.clone()
    err_local = max_abs_err(x_cpu, trained[str(dev)].x.cpu())
    out = {}
    for device in ("cpu", dev):
        state = trained[str(device)]
        state.x = x_cpu.clone().to(device)  # the step works in place
        comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=device)
        state = comm(state, cohort, perm, [True, True, True, False, True],
                     arrived=np.array([True, False, False, True, True]),
                     wire_seed=0xC0FFEE)
        out[str(device)] = (state.x.cpu(), state.h.cpu())
    (xc, hc), (xg, hg) = out["cpu"], out[str(dev)]
    err_comm = max(max_abs_err(xc, xg), max_abs_err(hc, hg))
    print(f"[reduced] one int8 wire_down round of {cfg.name} (n={n} c={CF} "
          f"s={SF} trimmed k=1, member 1 dropped): local steps card vs CPU "
          f"max abs err {err_local:.3e} (tolerance 1e-5), comm step from the "
          f"same trained state {err_comm} (tolerance 0)")
    if not err_local <= 1e-5 or err_comm != 0.0:
        raise AssertionError(f"reduced wire round: local {err_local}, comm "
                             f"{err_comm}")


def reduced_round_inputs(n: int, c: int):
    """The reduced config, the round's batches ``(2 steps, c, 2, 97)`` and
    the noise that makes the ``n - 1`` other client rows distinct, the same
    on every side."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import comm_ws, model_api

    cfg = gemma2_2b.REDUCED
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, c, 2, 97)))
    d_total = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    noise = torch.from_numpy(
        0.01 * rng.normal(size=(n - 1, d_total)).astype(np.float32))
    return cfg, toks, noise


def reduced_local(device, cfg, tcfg, n, cohort, toks, noise):
    """The round's state after its two local steps on ``device``, and the
    cohort's rows."""
    from repro_torch.dist import tamuna_dp

    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    state.x[1:] += noise
    state.x, state.h = state.x.to(device), state.h.to(device)
    local = tamuna_dp.make_local_step(cfg, tcfg)
    compact = tamuna_dp.gather_cohort(state, cohort)
    for t in range(toks.shape[0]):
        tk = toks[t].to(device)
        local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
    return state, compact


class intra_op_threads:
    """``torch.set_num_threads(k)`` inside the block (``None`` keeps the
    current count)."""

    def __init__(self, k):
        self.k = k

    def __enter__(self):
        self.prev = torch.get_num_threads()
        if self.k is not None:
            torch.set_num_threads(self.k)

    def __exit__(self, *exc):
        torch.set_num_threads(self.prev)


def reduced_round_err(dev, n, c, s, cohort, perm, down, arrived=None,
                      **robust):
    """One reduced-config round on the card and on the CPU (plain
    versions) with the same schedule, batches and (if given) arrived rows
    injected: ``(max abs err over x and h, where the worst coordinate
    lies)``."""
    from repro_torch.dist import comm_ws, model_api, tamuna_dp

    tcfg = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=c, s=s, p=P, **robust)
    cfg, toks, noise = reduced_round_inputs(n, c)
    down = torch.tensor(down)
    kw = {} if arrived is None else {"arrived": np.asarray(arrived)}
    out = {}
    for device in ("cpu", dev):
        state, compact = reduced_local(device, cfg, tcfg, n, cohort, toks,
                                       noise)
        comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device=device)
        state = comm(tamuna_dp.scatter_cohort(state, compact), cohort, perm,
                     down, **kw)
        out[str(device)] = (state.x.cpu(), state.h.cpu())
    (xc, hc), (xg, hg) = out["cpu"], out[str(dev)]
    err = max(max_abs_err(xc, xg), max_abs_err(hc, hg))
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    where = []
    for tag, a, b in (("x", xc, xg), ("h", hc, hg)):
        row, k = divmod(int((a - b).abs().argmax()), spec.d_total)
        leaf = max(i for i, o in enumerate(spec.offsets) if o <= k)
        where.append(f"{tag}[{row}] {spec.names[leaf]}"
                     f"[{k - spec.offsets[leaf]}]: CPU "
                     f"{float(a[row, k])!r}, card {float(b[row, k])!r}")
    return err, "; ".join(where)


def check_reduced_round(dev, n, c, s, cohort, perm, down, arrived=None,
                        **robust):
    """One reduced-config round on the card against the same round on the
    CPU (plain versions), gated at 1e-5."""
    err, where = reduced_round_err(dev, n, c, s, cohort, perm, down,
                                   arrived, **robust)
    print(f"[reduced] one round of gemma2-2b-reduced (n={n} c={c} s={s} "
          f"{robust.get('robust_agg', 'mean')}, arrived {arrived}) on the "
          f"card vs the CPU: max abs err {err:.3e} (tolerance 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"reduced round: card vs CPU err {err}; "
                             + where)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in units of one bf16 ulp of the larger of |a| and |b|
    (magnitudes below 2^-10 count as 2^-10, where f32 rounding of a sum of
    O(1) terms is still far below one ulp)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


def attn_bound(b, h, kvh, hd, n_keys, q_bytes, kv_bytes):
    """``(bound ms, "bytes" | "operations")`` of one decode attention: the
    visible K and V rows read once, q read, the output written; the
    logits and the weighted sum, 4 b h n_keys hd operations, at the
    card's rate for the inputs' type (bf16 tensor cores, else f32)."""
    nbytes = 2 * b * kvh * n_keys * hd * kv_bytes + 2 * b * h * hd * q_bytes
    ops = 4 * b * h * n_keys * hd
    peak = BF16_OPS_PER_S if max(q_bytes, kv_bytes) == 2 else F32_OPS_PER_S
    t_bytes, t_ops = bound_ms(nbytes), ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sdpa_call(q, k, v, pos: int, window):
    """``scaled_dot_product_attention`` with ``enable_gqa`` on the same
    inputs, the cache in its layout ``(b, kvh, S, hd)`` and the window as
    a boolean mask, softcap off (no PyTorch call applies one): the
    library's time for the same function without the softcap.  The
    library takes one dtype, so a bf16 cache under f32 queries is widened
    first (outside the timed call)."""
    import torch.nn.functional as F

    S = k.shape[1]
    qs = q[:, :, None, :]
    ks, vs = (t.transpose(1, 2).to(q.dtype).contiguous() for t in (k, v))
    kpos = torch.arange(S, device=q.device)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    mask = mask[None, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True)


def check_decode_case(q, k, v, pos, window, softcap, reps, plain_reps,
                      tol_ulps=None, tol_abs=None, library=False):
    """The decode kernel against its plain version on one case, both
    timed; the error in bf16 ulps (``tol_ulps``) or absolute
    (``tol_abs``)."""
    from repro_torch.kernels import decode_attn, ref

    b, h, hd = q.shape
    kvh = k.shape[2]
    got = decode_attn.decode_attention(q, k, v, pos, window=window,
                                       softcap=softcap)
    want = ref.decode_attention(q, k, v, pos, window=window,
                                softcap=softcap)
    torch.cuda.synchronize()
    err = max_abs_err(got.float(), want.float())
    ulps = bf16_ulps(got, want)
    del got, want
    bad = (tol_ulps is not None and not ulps <= tol_ulps) or (
        tol_abs is not None and not err <= tol_abs)
    wtag = "global" if window is None or window > k.shape[1] else window
    if bad:
        raise AssertionError(
            f"decode_attention {list(q.shape)} {q.dtype} on {k.dtype} cache "
            f"pos {pos} window {wtag}: max abs err {err}, {ulps} bf16 ulps")
    _, n_keys = decode_attn.visible_keys(pos, window)
    bound, by = attn_bound(b, h, kvh, hd, n_keys, q.element_size(),
                           k.element_size())
    rec = {
        "pos": pos, "window": wtag, "softcap": softcap,
        "max_abs_err": err, "bf16_ulps": ulps,
        "ms": cuda_ms(lambda: decode_attn.decode_attention(
            q, k, v, pos, window=window, softcap=softcap), reps),
        "plain_ms": cuda_ms(lambda: ref.decode_attention(
            q, k, v, pos, window=window, softcap=softcap), plain_reps),
        "bound_ms": bound, "bound_by": by,
        "splits": decode_attn.split_plan(
            b, kvh, n_keys, tiled=q.dtype == torch.bfloat16)[0],
    }
    if library:
        fn = sdpa_call(q, k, v, pos, window)
        lib = fn()[:, :, 0]
        nocap = ref.decode_attention(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        rec["library_max_abs_err_softcap_off"] = max_abs_err(
            lib.float(), nocap.float())
        del lib, nocap
        rec["library_ms"] = cuda_ms(fn, reps)
    return rec


def check_decode_kernels(dev):
    """``decode_attention`` against its plain version on the card: bf16
    queries and cache at gemma2-2b's attention (h 8, kvh 4, hd 256) over a
    32k cache, ``pos`` in {0, 4095, 30000} x window in {4096, global},
    softcap 50, within one bf16 ulp; f32 queries on f32 and bf16 caches at
    the reduced config's heads within 2e-5.  One case also poisons every
    cache row outside the visible keys with NaN: the kernel never reads
    them.  Returns one record per instantiation, the headline case first
    in ``cases``."""
    from repro_torch.kernels import decode_attn
    from repro_torch.models.transformer import GLOBAL_WINDOW

    g = torch.Generator(device=dev).manual_seed(8)
    recs = []
    cfgs = (
        ("decode_attention", DECODE_FULL, torch.bfloat16, torch.bfloat16,
         (30000, 4095, 0), 4096),
        ("decode_attention_f32", DECODE_F32, torch.float32, torch.float32,
         (4095, 1000, 0), 64),
        ("decode_attention_f32_bf16kv", DECODE_F32, torch.float32,
         torch.bfloat16, (4095, 1000, 0), 64),
    )
    for name, shp, qt, kvt, positions, local in cfgs:
        b, h, kvh, hd, S = (shp[x] for x in ("b", "h", "kvh", "hd", "S"))
        q = torch.randn(b, h, hd, generator=g, device=dev).to(qt)
        k = torch.randn(b, S, kvh, hd, generator=g, device=dev).to(kvt)
        v = torch.randn(b, S, kvh, hd, generator=g, device=dev).to(kvt)
        full = name == "decode_attention"
        tol = dict(tol_ulps=1.0) if qt == torch.bfloat16 else dict(
            tol_abs=2e-5)
        cases = []
        for pos in positions:
            for window in (GLOBAL_WINDOW, local):
                cases.append(check_decode_case(
                    q, k, v, pos, window, 50.0, 20 if full else 50,
                    3 if full else 10, library=True, **tol))
        # no softcap, and the NaN-poisoned rows outside [lo, pos]
        cases.append(check_decode_case(q, k, v, positions[1], local, None,
                                       20, 3, **tol))
        path_cases = []
        if full:
            # the serving paths' shapes: [serve]'s last step (8 x 512 rows)
            # and [serve_long]'s (4 x 4608 rows, local and global layer)
            long_rows = SERVE_LONG["prompt_len"] + SERVE_LONG["gen_len"]
            for bb, rows, window in (
                    (SERVE["batch"], SERVE["prompt_len"] + SERVE["gen_len"],
                     GLOBAL_WINDOW),
                    (SERVE_LONG["batch"], long_rows, GLOBAL_WINDOW),
                    (SERVE_LONG["batch"], long_rows, local)):
                ks, vs = (t[:bb, :rows].contiguous() for t in (k, v))
                path_cases.append(check_decode_case(
                    q[:bb].contiguous(), ks, vs, rows - 1, window, 50.0, 50,
                    10, library=True, **tol))
                path_cases[-1]["cache"] = [bb, rows, kvh, hd]
                del ks, vs
        pos = positions[1]
        lo, _ = decode_attn.visible_keys(pos, local)
        clean = decode_attn.decode_attention(q, k, v, pos, window=local,
                                             softcap=50.0)
        kp, vp = k.clone(), v.clone()
        for t in (kp, vp):
            t[:, :lo] = float("nan")
            t[:, pos + 1:] = float("nan")
        poisoned = decode_attn.decode_attention(q, kp, vp, pos,
                                                window=local, softcap=50.0)
        torch.cuda.synchronize()
        if not torch.equal(clean, poisoned):
            raise AssertionError(f"{name}: a row outside the visible keys "
                                 "reached the output")
        del kp, vp, clean, poisoned, q, k, v
        torch.cuda.empty_cache()
        head = cases[0]
        for c in cases + path_cases:
            cb, cs = c.get("cache", [b, S])[:2]
            print(f"[decode] {name} {[cb, h, hd]} on ({cb}, {cs}, {kvh}, {hd}) "
                  f"pos {c['pos']} window {c['window']} softcap "
                  f"{c['softcap']}: max abs err {c['max_abs_err']:.3e} "
                  f"({c['bf16_ulps']:.3f} bf16 ulps; tolerance "
                  f"{tol}), {c['ms']:.5f} ms vs plain {c['plain_ms']:.5f} "
                  f"ms, library {c.get('library_ms', float('nan')):.5f} ms "
                  f"(softcap off, err vs plain without softcap "
                  f"{c.get('library_max_abs_err_softcap_off', float('nan')):.3e}"
                  f"), bound {c['bound_ms']:.5f} ms ({c['bound_by']}; "
                  f"{c['bound_ms'] / c['ms']:.1%} of it), kernel over "
                  f"library {c['ms'] / c.get('library_ms', math.nan):.3f}"
                  f"x, {c['splits']} splits")
        print(f"[decode] {name}: cache rows outside the visible keys "
              "poisoned with NaN: output unchanged, bitwise")
        recs.append({
            "name": name, "shape": [[b, h, hd], [b, S, kvh, hd]],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": (f"{tol['tol_ulps']} bf16 ulp" if "tol_ulps" in tol
                          else tol["tol_abs"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "scaled_dot_product_attention(enable_gqa=True), "
                       "softcap off: no PyTorch call applies a softcap",
            "headline": f"pos {head['pos']} window {head['window']}",
            "cases": cases, "path_cases": path_cases,
        })
    return recs


def compress_owned(slot, d: int, c: int, s: int) -> int:
    """How many (row, coordinate) pairs the slots own under the cyclic
    template: the x entries ``compress`` must read."""
    r = np.arange(c)
    per_r = d // c + (r < d % c)  # coordinates k with k mod c = r
    band = (-(s * r)) % c
    return int(sum(per_r[(sl + band) % c < s].sum()
                   for sl in np.asarray(slot).tolist() if 0 <= sl < c))


def check_compress(x, slot, c: int, s: int, reps: int,
                   plain_reps: int) -> dict:
    """``compress`` against its plain version on ``x`` (bitwise), both
    timed; returns the measurements."""
    from repro_torch.kernels import compress, ref

    got = compress.compress(x, slot, c, s)
    want = ref.compress(x, slot, c, s)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    del got, want
    n = 1 if x.dim() == 1 else x.shape[0]
    name = (f"compress{'_1d' if x.dim() == 1 else ''}_"
            f"{'f64' if x.dtype == torch.float64 else 'f32'}")
    if err != 0.0:
        raise AssertionError(f"{name} {list(x.shape)}: max abs err {err}, "
                             "want 0")
    owned = compress_owned(slot.cpu(), x.shape[-1], c, s)
    return {
        "name": name, "shape": list(x.shape), "max_abs_err": err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: compress.compress(x, slot, c, s), reps),
        "plain_ms": cuda_ms(lambda: ref.compress(x, slot, c, s),
                            plain_reps),
        # owned x entries read, every output written, slot read
        "bound_ms": bound_ms(x.element_size() * (owned + x.numel())
                             + 4 * n),
    }


def check_compress_kernels(d_total, dev):
    """``compress`` in both ranks and types against its plain version: f64
    at the convex paths' shapes and round-0 permutations, f32 on the comm
    workspace of the LM paths (slot ``[1, -1, 0, 2]``, c=3, s=2, an idle
    row of NaN) and its one-row form; returns one record per
    instantiation."""
    from repro_torch.core import masks, theory
    from repro_torch.kernels import compress

    g = torch.Generator(device=dev).manual_seed(7)
    d = CONVEX["d"]
    recs = {}
    for c, reps in ((100, 200), (1000, 100)):
        s = theory.recommended_s(c, d, 0.0)
        perm = torch.from_numpy(masks.sample_permutation(0, 0, c)).to(
            device=dev, dtype=torch.int32)
        x = torch.randn(c, d, generator=g, device=dev, dtype=torch.float64)
        rec = check_compress(x, perm, c, s, reps, 20)
        # the kernel body's own time, without the wrapper's host time
        rec["kernel_ms"], rec["kernel_ms_by"] = kernel_only_ms(
            lambda: compress.compress(x, perm, c, s), "compress_kernel")
        print(f"[check] compress_f64 {[c, d]}: kernel only "
              f"{rec['kernel_ms']:.4f} ms ({rec['kernel_ms_by']}), per call "
              f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms")
        if c == 100:
            recs["compress_f64"] = rec
            x1 = x[0].contiguous()
            recs["compress_1d_f64"] = check_compress(x1, perm[:1], c, s, 200,
                                                     20)
        else:  # the [convex_full] shape rides along
            recs["compress_f64"].update(
                {f"full_{k}": rec[k] for k in ("shape", "max_abs_err", "ms",
                                               "plain_ms", "bound_ms",
                                               "kernel_ms", "kernel_ms_by")})
        del x
    x = torch.randn(N, d_total, generator=g, device=dev)
    x[1] = float("nan")  # the idle row never reaches the output
    slot = torch.tensor([1, -1, 0, 2], dtype=torch.int32, device=dev)
    recs["compress_f32"] = check_compress(x, slot, C, S, 5, 2)
    x1 = x[0]
    recs["compress_1d_f32"] = check_compress(x1, slot[:1], C, S, 10, 2)
    del x, x1
    torch.cuda.empty_cache()
    return [recs[k] for k in ("compress_f64", "compress_f32",
                              "compress_1d_f64", "compress_1d_f32")]


def check_convex_card_vs_cpu(prob, cfg, rounds: int = 5) -> None:
    """Gate (a): the first rounds of ``tamuna.run`` on the card against the
    same rounds, same schedule, on the CPU (plain versions): x_bar and h
    within 1e-10 relative."""
    from repro_torch.core import tamuna

    card = tamuna.run(prob, cfg, rounds, record_every=rounds)["state"]
    cpu = tamuna.run(prob.to("cpu"), cfg, rounds,
                     record_every=rounds)["state"]
    errs = [float((a.cpu() - b).abs().max() / b.abs().max())
            for a, b in ((card.x_bar, cpu.x_bar), (card.h, cpu.h))]
    print(f"[convex] first {rounds} rounds ({card.total_local_steps} local "
          f"steps) on the card vs the CPU: relative max err x_bar "
          f"{errs[0]:.3e}, h {errs[1]:.3e} (tolerance 1e-10)")
    if not (max(errs) <= 1e-10
            and card.total_local_steps == cpu.total_local_steps):
        raise AssertionError(f"[convex] card vs CPU: {errs}")


def run_convex_path(tag, prob, c: int, rounds: int) -> dict:
    """Drive ``tamuna.run`` for ``rounds`` rounds of the paper-scale
    problem at cohort ``c`` with the launch counts set to 0 just before and
    read just after; gates (b) sum_i h_i = 0 to 1e-10 of max|h|, (c) a
    finite suboptimality that ends below where it started and (d) two
    ``compress_f64`` launches per round.  Returns the launch counts."""
    from repro_torch.core import tamuna, theory
    from repro_torch.kernels import _build

    cfg = tamuna.TamunaConfig.tuned(prob, c=c)
    print(f"[{tag}] n={prob.n} d={prob.d} c={c} s={cfg.s} p={cfg.p:.6f} "
          f"(1/p = {1 / cfg.p:.3f} local steps per round) gamma="
          f"{cfg.gamma:.6e} eta={cfg.eta:.6f}, {rounds} rounds, float64")
    start = float(prob.suboptimality(torch.zeros_like(prob.x_star)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tr = tamuna.run(prob, cfg, rounds, seed=0,
                    record_every=max(1, rounds // 8))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    state = tr["state"]
    for i, r in enumerate(tr["rounds"]):
        print(f"[{tag}] round {r}: local steps {tr['local_steps'][i]} "
              f"suboptimality {tr['suboptimality'][i]:.6e} lyapunov "
              f"{tr['lyapunov'][i]:.6e} at {tr['seconds'][i]:.3f} s")
    steps = state.total_local_steps
    print(f"[{tag}] {rounds} rounds, {steps} local steps in {wall:.3f} s: "
          f"{wall / rounds * 1e3:.4f} ms per round, "
          f"{wall / steps * 1e3:.4f} ms per local step (record points "
          f"included); up_floats {state.up_floats:.0f} down_floats "
          f"{state.down_floats:.0f} per client")
    print(f"[{tag}] launches {({k: v for k, v in launches.items() if v})}")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)")
    chi = cfg.eta / cfg.p
    tau = theory.theorem1_rate(cfg.gamma, prob.mu, prob.L, cfg.p, chi,
                               prob.n, cfg.s)
    ly, st = tr["lyapunov"], tr["local_steps"]
    rate = (ly[-1] / ly[0]) ** (1.0 / (st[-1] - st[0]))
    print(f"[{tag}] Theorem 1 tau = {tau:.10f} per local step; measured "
          f"Lyapunov rate {rate:.10f} per local step over steps "
          f"{st[0]}..{st[-1]}")
    ratio = h_sum_ratio(state.h, prob.d)
    print(f"[{tag}] |sum_i h_i| / max|h| = {ratio:.3e} (limit 1e-10); "
          f"suboptimality {start:.6e} at x0 = 0 -> "
          f"{tr['suboptimality'][-1]:.6e}")
    if not ratio <= 1e-10:
        raise AssertionError(f"[{tag}] sum_i h_i = 0 violated: {ratio}")
    sub = tr["suboptimality"]
    if not (np.isfinite(sub).all() and sub[-1] < start and sub[-1] < sub[0]):
        raise AssertionError(f"[{tag}] suboptimality did not fall: {sub}")
    others = {k: v for k, v in launches.items() if k != "compress_f64" and v}
    if launches["compress_f64"] != 2 * rounds or others:
        raise AssertionError(f"[{tag}] want 2 compress_f64 launches per "
                             f"round and nothing else: {launches}")
    del tr, state
    torch.cuda.empty_cache()
    return launches


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
    sum_i h_i = 0 (printed in any case).  Returns the launch counts."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist import comm_ws, model_api, rounds, tamuna_dp
    from repro_torch.kernels import _build

    d = comm_ws.workspace_spec(model_api.param_specs(cfg)).d_total
    desc = [f"n={n} c={tcfg.c} s={tcfg.s} robust_agg={tcfg.robust_agg} "
            f"trim_k={tcfg.trim_k} wire_precision={tcfg.wire_precision} "
            f"wire_down={tcfg.wire_down}"]
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
              f"{row['up_floats']:.0f} down_floats {row['down_floats']:.0f} "
              f"up_bytes {row['up_bytes']:.0f} down_bytes "
              f"{row['down_bytes']:.0f}" + (f" {extra}" if extra else ""))
    print(f"[{tag}] launches {launches}")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"[{tag}] non-finite loss: {rows}")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"[{tag}] a kernel of {need} was not "
                             f"launched: {launches}")
    ratio = h_sum_ratio(state.h, d)
    print(f"[{tag}] |sum_i h_i| / max|h| = {ratio:.3e}"
          + (" (limit 1e-4)" if check_h_sum else " (not gated)"))
    if check_h_sum:
        if not ratio <= 1e-4:
            raise AssertionError(f"[{tag}] sum_i h_i = 0 violated: ratio "
                                 f"{ratio}")
    del state, pipe
    torch.cuda.empty_cache()
    return launches


class count_plain_attention:
    """Counts the calls of the two plain attentions of the decode path
    (the model's ``_decode_scores_dyn`` and the kernel's plain version
    ``ref.decode_attention``) inside the block."""

    def __enter__(self):
        from repro_torch.kernels import ref
        from repro_torch.models import transformer

        self.calls = 0
        self.saved = [(transformer, "_decode_scores_dyn"),
                      (ref, "decode_attention")]
        self.fns = [getattr(m, a) for m, a in self.saved]

        def counted(fn):
            def wrapper(*args, **kw):
                self.calls += 1
                return fn(*args, **kw)
            return wrapper

        for (m, a), fn in zip(self.saved, self.fns):
            setattr(m, a, counted(fn))
        return self

    def __exit__(self, *exc):
        for (m, a), fn in zip(self.saved, self.fns):
            setattr(m, a, fn)


def serve_params_on(cfg, dev, seed=0):
    """Random parameters from ``seed`` on ``dev``, cast once for serving
    (the f32 originals freed)."""
    from repro_torch.dist import model_api
    from repro_torch.serve_utils import serving_params

    params = serving_params(model_api.init(cfg, seed=seed, device=dev), cfg)
    torch.cuda.empty_cache()
    return params


def rerun_last_step(params, cfg, res, prompts, device, attend_fn):
    """The served batch's last decode step again, on ``device`` from a
    copy of the final cache (the step rewrites its own row at the last
    position and attends to the same earlier rows): ``(logits, cache)``."""
    from repro_torch.dist import model_api

    pos = prompts.shape[1] + res["tokens"].shape[1] - 1
    cache = {k: v.to(device, copy=True) for k, v in res["cache"].items()}
    p = params if device == res["logits"].device else {
        k: v.to(device) for k, v in params.items()}
    with torch.no_grad():
        return model_api.decode(p, cfg, res["tokens"][:, -1:].to(device),
                                cache, pos, attend_fn=attend_fn)


def run_serve_reduced(dev) -> dict:
    """``[serve_reduced]``: the reduced gemma2-2b (f32 compute) served for
    SERVE_REDUCED on the card (through the kernel) and on the CPU (the
    model's plain attention), with the same prompts and weights.  On an
    f32 cache the greedy tokens must be equal and every logit of the last
    step within 1e-4 of the largest; on a bf16 cache (the CLI's) the last
    step is rerun on the CPU from the card's own final cache and held to
    the same 1e-4 (run through many steps, one-ulp roundings of the cache
    compound).  Returns the launch counts."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn import make_attend_fn
    from repro_torch.launch import serve

    cfg = gemma2_2b.REDUCED
    sr = SERVE_REDUCED
    params = serve_params_on(cfg, dev)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    prompts = serve.make_prompts(sr["batch"], sr["prompt_len"], cfg.vocab,
                                 0, "cpu")
    print(f"[serve_reduced] {cfg.name} (f32, window {cfg.sliding_window}), "
          f"batch {sr['batch']}, prompt {sr['prompt_len']}, gen "
          f"{sr['gen_len']}: card (kernel) vs CPU (plain attention)")
    launches = dict.fromkeys(_build.launch_counts, 0)
    with intra_op_threads(REDUCED_CPU_THREADS):
        for kv in (torch.float32, torch.bfloat16):
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            with count_plain_attention() as plain:
                card = serve.run(params, cfg, prompts.to(dev),
                                 sr["gen_len"], kv_dtype=kv,
                                 attend_fn=make_attend_fn(cfg))
            got = {k: v for k, v in _build.launch_counts.items() if v}
            for k, v in got.items():
                launches[k] += v
            steps = sr["prompt_len"] + sr["gen_len"]
            name = ("decode_attention_f32" if kv == torch.float32
                    else "decode_attention_f32_bf16kv")
            if got != {name: cfg.n_layers * steps} or plain.calls:
                raise AssertionError(f"[serve_reduced] {kv} cache: launches "
                                     f"{got}, plain attention calls "
                                     f"{plain.calls}")
            if kv == torch.float32:
                cpu = serve.run(params_cpu, cfg, prompts, sr["gen_len"],
                                kv_dtype=kv)
                want, same = cpu["logits"], torch.equal(
                    card["tokens"].cpu(), cpu["tokens"])
            else:
                want, cache = rerun_last_step(params_cpu, cfg, card, prompts,
                                              "cpu", None)
                pos = steps - 1
                same = all(bf16_ulps(cache[n][:, :, pos],
                                     card["cache"][n][:, :, pos].cpu()) <= 1
                           for n in ("k", "v"))
            err = float((card["logits"].cpu() - want).abs().max()
                        / want.abs().max())
            print(f"[serve_reduced] {kv} cache: {got}; last logits card vs "
                  f"CPU {err:.3e} of the largest (tolerance 1e-4); "
                  + ("greedy tokens equal" if kv == torch.float32 else
                     "rows written at the last step within one bf16 ulp")
                  + f": {same}; continuations {card['tokens'][:2].tolist()}")
            if not (card["finite"] and err <= 1e-4 and same):
                raise AssertionError(f"[serve_reduced] {kv} cache: err {err}"
                                     f", match {same}")
    return launches


def profile_last_steps(tag, params, cfg, res, prompts, dev, attend_fn,
                       reps: int = 3) -> None:
    """The served batch's last decode step run ``reps`` more times under
    ``torch.profiler`` (after one warm-up): wall time per step, the
    device's busy time per step (the sum of the kernels' device times)
    and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    rerun_last_step(params, cfg, res, prompts, dev, attend_fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            rerun_last_step(params, cfg, res, prompts, dev, attend_fn)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in rows) / reps / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    attn = [e for e in rows if "decode_attn" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / reps / 1e3
    print(f"[{tag}] profiled step (last step rerun {reps} times, cache "
          f"copy included): wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / (wall * 1e3):.1%}); decode_attention "
          f"{attn_ms:.4f} ms in {sum(e.count for e in attn) // reps} "
          f"launches ({attn_ms / cfg.n_layers * 1e3:.2f} us of device "
          f"time per layer); top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / reps / 1e3:.3f}"
                      f" ms x{e.count // reps}" for e in top))


def run_serve(dev) -> dict:
    """``[serve]``: gemma2-2b at published widths and full depth through
    ``launch.serve.run``: SERVE's batch, prompt and generation on a bf16
    cache, the parameters cast to bf16 once.  Gates: finite logits at
    every step, ``n_layers x (prompt + gen)`` decode-kernel launches and no
    call of a plain attention."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn import make_attend_fn
    from repro_torch.launch import serve

    cfg = gemma2_2b.CONFIG
    sv = SERVE
    steps = sv["prompt_len"] + sv["gen_len"]
    params = serve_params_on(cfg, dev)
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    prompts = serve.make_prompts(sv["batch"], sv["prompt_len"], cfg.vocab, 0,
                                 dev)
    cache_b = 2 * cfg.n_layers * sv["batch"] * steps * cfg.n_kv_heads \
        * cfg.head_dim * 2
    print(f"[serve] {cfg.name}, {cfg.n_layers} layers at published widths, "
          f"parameters {nbytes} B in {cfg.dtype}; batch {sv['batch']}, "
          f"prompt {sv['prompt_len']}, gen {sv['gen_len']}, bf16 cache "
          f"{cache_b} B")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with count_plain_attention() as plain:
        res = serve.run(params, cfg, prompts, sv["gen_len"],
                        kv_dtype=torch.bfloat16,
                        attend_fn=make_attend_fn(cfg))
    counts = dict(_build.launch_counts)
    launches = {k: v for k, v in counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    dt = res["prefill_s"] + res["decode_s"]
    print(f"[serve] {steps} decode steps: prefill {res['prefill_s']:.3f} s "
          f"({res['prefill_s'] / sv['prompt_len'] * 1e3:.3f} ms per step), "
          f"generation {res['decode_s']:.3f} s "
          f"({res['decode_s'] / sv['gen_len'] * 1e3:.3f} ms per step, "
          f"{sv['batch'] * sv['gen_len'] / res['decode_s']:.1f} tok/s); "
          f"{sv['batch'] * steps / dt:.1f} tok/s over all steps")
    print(f"[serve] max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    print(f"[serve] launches {launches}, plain attention calls "
          f"{plain.calls}, logits finite {res['finite']}")
    print(f"[serve] sample continuations: {res['tokens'][:2].tolist()}")
    profile_last_steps("serve", params, cfg, res, prompts, dev,
                       make_attend_fn(cfg))
    if not res["finite"] or plain.calls or launches != {
            "decode_attention": cfg.n_layers * steps}:
        raise AssertionError(f"[serve] finite {res['finite']}, launches "
                             f"{launches}, plain calls {plain.calls}")
    del params, res
    torch.cuda.empty_cache()
    return counts


def run_serve_long(dev) -> dict:
    """``[serve_long]``: gemma2-2b at published widths cut to 2 layers
    (one local, one global) served past the 4096 window: SERVE_LONG's
    batch, prompt and generation on a bf16 cache.  Gates: finite logits,
    ``2 x (prompt + gen)`` launches, no plain attention, and the last
    step rerun on the card from the same cache with the kernel's plain
    version (within 1e-2 of the largest logit: the two round the
    attention output to bf16 apart by at most one ulp, which the next
    layer carries on) and with the model's plain attention (within 5e-2:
    it also rounds the probabilities to bf16); a step that drops the local
    layer's window is printed beside them.  Returns the launch counts."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decode_attn import make_attend_fn
    from repro_torch.launch import serve

    cfg = dataclasses.replace(gemma2_2b.CONFIG, n_layers=2)
    sl = SERVE_LONG
    steps = sl["prompt_len"] + sl["gen_len"]
    params = serve_params_on(cfg, dev)
    prompts = serve.make_prompts(sl["batch"], sl["prompt_len"], cfg.vocab, 0,
                                 dev)
    print(f"[serve_long] {cfg.name} at published widths cut to "
          f"{cfg.n_layers} layers (windows {cfg.layer_windows()}), batch "
          f"{sl['batch']}, prompt {sl['prompt_len']}, gen {sl['gen_len']}, "
          f"bf16 cache of {steps} rows")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with count_plain_attention() as plain:
        res = serve.run(params, cfg, prompts, sl["gen_len"],
                        kv_dtype=torch.bfloat16,
                        attend_fn=make_attend_fn(cfg))
    counts = dict(_build.launch_counts)
    launches = {k: v for k, v in counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve_long] prefill {res['prefill_s']:.3f} s "
          f"({res['prefill_s'] / sl['prompt_len'] * 1e3:.3f} ms per step), "
          f"generation {res['decode_s']:.3f} s "
          f"({res['decode_s'] / sl['gen_len'] * 1e3:.3f} ms per step); "
          f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); "
          f"launches {launches}, plain attention calls {plain.calls}")

    def kernel_plain(q, k, v, pos, window):
        return ref.decode_attention(q[:, 0], k, v, pos, window=window,
                                    softcap=cfg.attn_softcap)[:, None]

    def no_window(q, k, v, pos, window):
        return kernel_plain(q, k, v, pos, None)

    profile_last_steps("serve_long", params, cfg, res, prompts, dev,
                       make_attend_fn(cfg))
    top = res["logits"].abs().max()
    errs = {}
    for tag, fn in (("kernel's plain version", kernel_plain),
                    ("model's plain attention", None),
                    ("without the local window", no_window)):
        lg, _ = rerun_last_step(params, cfg, res, prompts, dev, fn)
        errs[tag] = float((lg - res["logits"]).abs().max() / top)
    print(f"[serve_long] last step (pos {steps - 1}) rerun from the same "
          f"cache on the card, max logit difference over the largest: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (tolerances 1e-2 and 5e-2 for the first two)")
    if not (res["finite"] and not plain.calls
            and launches == {"decode_attention": cfg.n_layers * steps}
            and errs["kernel's plain version"] <= 1e-2
            and errs["model's plain attention"] <= 5e-2):
        raise AssertionError(f"[serve_long] finite {res['finite']}, launches "
                             f"{launches}, plain calls {plain.calls}, errs "
                             f"{errs}")
    del params, res
    torch.cuda.empty_cache()
    return counts


def run_serve_paths(dev) -> dict:
    """The serving paths, launch counts set to 0 just before each and read
    just after; returns them by path."""
    return {"serve_reduced": run_serve_reduced(dev),
            "serve": run_serve(dev),
            "serve_long": run_serve_long(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import (cohort, comm_ws, faults, model_api,
                                  tamuna_dp, wire)
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
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            print(f"[build] {line.strip()}")
    spills = [line for line in log.splitlines() if "spill" in line
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    print(f"[build] {len(spills)} kernel instantiations spill registers")
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

    recs, by_path = [], {}
    recs += check_uplink_kernels(spec, tcfg, dev)
    torch.cuda.empty_cache()
    recs.append(check_local_step(spec, dev))
    torch.cuda.empty_cache()
    recs += check_fault_kernels(spec, dev)
    torch.cuda.empty_cache()
    recs += check_wire_kernels(spec, dev)
    torch.cuda.empty_cache()
    recs += check_compress_kernels(spec.d_total, dev)
    for rec in recs:
        print(f"[check] {rec['name']} {rec['shape']}: max abs err "
              f"{rec['max_abs_err']} (tolerance {rec['tolerance']}), "
              f"{rec['ms']:.3f} ms vs plain {rec['plain_ms']:.3f} ms, "
              f"bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of it)")
    # the CPU side on one intra-op thread: its multithreaded products
    # are not repeatable from run to run, the card's are
    with intra_op_threads(REDUCED_CPU_THREADS):
        check_reduced_round(dev, N, C, S, [0, 2, 3], [2, 0, 1],
                            [True, True, False, True])
        # the faulted round: member 1 dropped, the trimmed mean
        check_reduced_round(dev, NF, CF, SF, [0, 1, 3, 4],
                            [3, 0, 2, 1], [True, True, True, False, True],
                            arrived=[True, False, False, True, True],
                            robust_agg="trimmed", trim_k=1)
        check_reduced_wire_round(dev)
    torch.cuda.empty_cache()

    # ---- the paths: 3 rounds of full-width 2-layer gemma2-2b each --------
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
    tcfg_w = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=C, s=S, p=P,
                                        wire_precision="auto",
                                        wire_down=True)
    kinds = [wire.resolve_kind(D, "auto") for D in spec.dims]
    print(f"[wire] auto wire kinds: {kinds.count('f16')} f16 leaves "
          f"({sum(D for D, k in zip(spec.dims, kinds) if k == 'f16')} "
          f"coordinates), {kinds.count('int8')} int8 leaves; per-client "
          f"UpCom bytes per round: f32 {up_bytes(spec, C, S, 'f32'):.0f}, "
          f"auto {up_bytes(spec, C, S, 'auto'):.0f}, int8 "
          f"{up_bytes(spec, C, S, 'int8'):.0f} (int8 over f32: "
          f"{up_bytes(spec, C, S, 'f32') / up_bytes(spec, C, S, 'int8'):.4f}"
          f"x)")
    by_path["wire"] = run_path(
        "wire", cfg, tcfg_w, N, dev,
        need=("masked_sum_dequant", "masked_sum_f16", "wire_quantize",
              "h_update", "fused_local_step"),
        check_h_sum=False)
    tcfg_wf = tamuna_dp.DistTamunaConfig(gamma=GAMMA, c=CF, s=SF, p=P,
                                         wire_precision="int8")
    by_path["wire_faults"] = run_path(
        "wire_faults", cfg, tcfg_wf, NF, dev,
        need=("masked_sum_dequant_counts", "wire_quantize",
              "h_update_covered", "fused_local_step"),
        check_h_sum=False,
        plan=cohort.CohortPlan(0, NF, CF),
        faults=faults.FaultPlan(seed=0, n=NF, p_drop=0.25),
        policy="quorum")

    # ---- the convex core at paper scale: Fig. 3's problem, c=100, 1000 --
    from repro_torch.core import problems, tamuna

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob = problems.make_logreg_problem(**CONVEX, name="realsim-like",
                                        device=dev)
    setup = prob.meta["setup_s"]
    print(f"[convex] problem {prob.name} {CONVEX}: set-up "
          f"{time.perf_counter() - t0:.3f} s (data {setup['data']:.3f} s, "
          f"L {setup['L']:.3f} s, Newton {setup['newton']:.3f} s in "
          f"{prob.meta['newton_iters']} steps); mu {prob.mu:.10e} L "
          f"{prob.L:.10e} f* {prob.f_star:.15e} |grad f(x*)| "
          f"{float(prob.grad(prob.x_star).norm()):.3e}; shared by both "
          f"convex paths")
    check_convex_card_vs_cpu(prob, tamuna.TamunaConfig.tuned(prob, c=100))
    torch.cuda.empty_cache()
    by_path["convex"] = run_convex_path("convex", prob, 100,
                                        CONVEX_ROUNDS["convex"])
    by_path["convex_full"] = run_convex_path("convex_full", prob, 1000,
                                             CONVEX_ROUNDS["convex_full"])
    del prob
    torch.cuda.empty_cache()

    recs += check_decode_kernels(dev)
    torch.cuda.empty_cache()
    by_path.update(run_serve_paths(dev))

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
        "masked_sum_dequant": ("src/repro/kernels/uplink.py:80", "wire"),
        "masked_sum_dequant_counts": ("src/repro/kernels/uplink.py:94",
                                      "wire_faults"),
        "masked_sum_f16": ("src/repro/kernels/uplink.py:55", "wire"),
        # no path sends bf16 lanes (--wire-precision bf16 does)
        "masked_sum_bf16": ("src/repro/kernels/uplink.py:55", None),
        "wire_quantize": ("src/repro/dist/wire.py:245 quantize_to_int, "
                          "src/repro/dist/wire.py:221 quantize", "wire"),
        "compress_f64": ("src/repro/kernels/compress.py:71", "convex"),
        # no path of either package compresses f32 or one vector
        "compress_f32": ("src/repro/kernels/compress.py:71", None),
        "compress_1d_f64": ("src/repro/kernels/compress.py:63", None),
        "compress_1d_f32": ("src/repro/kernels/compress.py:63", None),
        "decode_attention": ("src/repro/kernels/decode_attn.py:33", "serve"),
        "decode_attention_f32": ("src/repro/kernels/decode_attn.py:33",
                                 "serve_reduced"),
        "decode_attention_f32_bf16kv": (
            "src/repro/kernels/decode_attn.py:33", "serve_reduced"),
    }
    kernels = []
    for rec in recs:
        body, path_name = replaces[rec["name"]]
        kernels.append({
            "name": rec["name"], "route": "cuda", "source": src,
            "replaces": body,
            "launches": (0 if path_name is None
                         else by_path[path_name][rec["name"]]),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec.get("bound_by", "bytes"),
            "library_ms": rec.get("library_ms"),
            "shape": rec["shape"], "tolerance": rec["tolerance"],
            "path": path_name,
            "launches_by_path": {p: by_path[p][rec["name"]]
                                 for p in by_path},
            **{k: v for k, v in rec.items() if k not in (
                "name", "shape", "max_abs_err", "tolerance", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")},
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
