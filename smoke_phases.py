#!/usr/bin/env python3
"""Named phases of ``chip_smoke.py``, from one or more checkouts of the
repo, each checkout in a fresh process in the order given, on one CUDA
device: to compare two trees on one card (parent, change, change, parent)
or to rerun a phase alone.  Each checkout builds its kernels under its own
tree at its first process.  Each process prints the phases' own lines;
a summary of every ``[tag] N decode steps`` reading (prefill and
generation ms per step), of every ``[domain]`` kernel time and of every
training path's L=1 round seconds and peak memory by process follows.
The environment passes on, so ``REPRO_DISABLE_FLASH=1 python3
smoke_phases.py --tree . --phase memory_dense`` gives the memory table's
dense rows.

  python3 smoke_phases.py --tree _checkout/parent --tree . --tree . \\
      --tree _checkout/parent --phase serve --phase serve_rwkv
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

# each phase as chip_smoke.py's main calls it
PHASES = {
    "serve": "run_serve(dev)",
    "serve_rwkv": 'run_serve(dev, "serve_rwkv", "rwkv6-7b", SERVE_FAMILY)',
    "serve_zamba2": ('run_serve(dev, "serve_zamba2", "zamba2-2.7b", '
                     'SERVE_FAMILY)'),
    "train_whisper": "run_whisper_path(dev)",
    # the [train_*] paths, as main calls them (TWO_LAYERS: gemma2-2b cut
    # to 2 layers, main's cfg)
    "train": ('run_path("train", TWO_LAYERS, tamuna_dp.DistTamunaConfig('
              'gamma=GAMMA, c=C, s=S, p=P), N, dev, need=("masked_sum", '
              '"h_update", "fused_local_step"), check_h_sum=True)'),
    "train_families": "run_family_paths(dev)",
    "train_new_families": "run_new_family_paths(dev)",
    "train_options": "run_train_options(TWO_LAYERS, dev)",
    # the memory table's rows of the attention this process's switch gives
    # (the dense path under REPRO_DISABLE_FLASH=1)
    "memory_dense": 'memory_rows(dev, ("dense",))',
    # the kernels past the staged limits, timed on this file's inputs
    # (time_domain below): any tree's wrappers, parent or change
    "domain": "time_domain(dev)",
    # the model-sharded int wire's scales and quantizer (time_wire_at)
    "wire_at": "time_wire_at(dev)",
}

# h_update past 4096 rows at a population's size: 8192 clients, a cohort
# of 64 at s = 2 downloading (x and h 8.6 GB each)
H_POPULATION = dict(n=8192, d=(1 << 18) + 3, cohort=64, s=2)
# robust_sum's s past the register kernel's 16 that time_domain reads:
# chip_smoke.check_domain_kernels' two, and the 64-value network's ends
DOMAIN_S = (17, 32, 33, 64)


def robust_domain_inputs(s: int, d: int, dev):
    """``robust_sum``'s inputs past s = 16 on ``(s + 4, d)``: s members on
    s of the m = s + 2 columns in a shuffled order, then a dropped and an
    idle row (NaN) and two rows on the last columns, which the members
    hold too at s = 17 and 32 (those columns' coordinates have up to
    s + 2 owners), with +-inf, ties and a +0/-0 tie.  Returns
    ``(x, slot, band, m)``, made from the seed s."""
    import numpy as np
    import torch
    from repro_torch.dist import comm_ws

    m, n = s + 2, s + 4
    g = torch.Generator(device=dev).manual_seed(s)
    slot = torch.tensor(
        np.random.default_rng(s).permutation(m)[:s].tolist()
        + [-1, -1, s, s + 1], dtype=torch.int32, device=dev)
    band = comm_ws.cyclic_band([d], m, s, dev)
    x = torch.randn(n, d, generator=g, device=dev)
    x[s:s + 2] = float("nan")
    x[0, ::1000] = float("inf")
    x[2, 500::1000] = float("-inf")
    x[3, ::7] = x[0, ::7]
    x[4, 3::29], x[5, 3::29] = 0.0, -0.0
    return x, slot, band, m


def h_update_domain_inputs(n: int, d: int, m: int, s: int, population: bool,
                           dev) -> dict:
    """``h_update``'s inputs past 4096 rows on ``(n, d)``: m owners' slots
    on shuffled rows, the idle rows' x NaN, h at 0.01 of x's scale, 75% of
    the coordinates covered; a quarter of the rows download, or at a
    population the cohort.  Keys x, h, x_bar, slot, down, band, covered;
    made from the seed n."""
    import numpy as np
    import torch
    from repro_torch.dist import comm_ws

    rng = np.random.default_rng(n)
    g = torch.Generator(device=dev).manual_seed(n)
    slot_np = np.full(n, -1, np.int32)
    slot_np[rng.choice(n, m, replace=False)] = rng.permutation(m)
    down_np = (slot_np >= 0) if population else rng.random(n) < 0.25
    x = torch.randn(n, d, generator=g, device=dev)
    x[torch.from_numpy(slot_np < 0).to(dev)] = float("nan")
    return {
        "x": x,
        "h": torch.randn(n, d, generator=g, device=dev).mul_(0.01),
        "x_bar": torch.randn(d, generator=g, device=dev),
        "covered": torch.rand(d, generator=g, device=dev) < 0.75,
        "slot": torch.from_numpy(slot_np).to(dev),
        "down": torch.from_numpy(down_np.astype(np.int32)).to(dev),
        "band": comm_ws.cyclic_band([d], m, s, dev),
    }


def time_domain(smoke: dict, dev) -> None:
    """``robust_sum`` at each s of DOMAIN_S, trimmed (k = 2) and median, on
    ``robust_domain_inputs``, and ``h_update`` in both forms at 4097 rows
    (64 owners, ``chip_smoke.D_DOMAIN_ROWS`` columns) and at H_POPULATION,
    through the wrappers of the tree whose ``chip_smoke.py`` gave
    ``smoke``: ms per call (CUDA events, 5 calls after a warm-up), the
    timing ``chip_smoke.check_domain_kernels`` reports."""
    import torch
    from repro_torch.kernels import uplink

    cuda_ms = smoke["cuda_ms"]
    d = smoke["D_DOMAIN"]
    for s in DOMAIN_S:
        x, slot, band, m = robust_domain_inputs(s, d, dev)
        for kind, k in (("trimmed", 2), ("median", 0)):
            ms = cuda_ms(lambda: uplink.robust_sum(x, slot, band, m, s,
                                                   kind=kind, k=k), 5)
            print(f"[domain] robust_sum s={s} {kind} ({s + 4}, {d}): "
                  f"{ms:.4f} ms", flush=True)
        del x
    pop = H_POPULATION
    for n, dn, m, s in ((4097, smoke["D_DOMAIN_ROWS"], 64, 2),
                        (pop["n"], pop["d"], pop["cohort"], pop["s"])):
        a = h_update_domain_inputs(n, dn, m, s, n == pop["n"], dev)
        for name, c in (("h_update", None), ("h_update_covered",
                                              a["covered"])):
            ms = cuda_ms(lambda: uplink.h_update(
                a["x"], a["h"], a["x_bar"], a["slot"], a["band"], m, s,
                0.37, down=a["down"], covered=c), 5)
            print(f"[domain] {name} ({n}, {dn}): {ms:.4f} ms", flush=True)
        del a
        torch.cuda.empty_cache()

def time_wire_at(smoke: dict, dev) -> None:
    """The coordinate-table form of the int wire through the wrappers of
    the tree whose ``chip_smoke.py`` gave ``smoke``, on
    ``chip_smoke.check_wire_at_kernels``' shapes: ``[comm_tp]``'s int8
    group (model rank 0's blocks of 2-layer gemma2-2b, ``N`` rows) and a
    block of runs of 300 (``WIRE_AT_GENERAL``, this file's copy, so a
    parent tree needs none), each with nonfinite entries: the scales
    (``comm_ws._group_scales``, the chunk maxima then
    ``wire.scales_of_max``), the UpCom quantizer (``pack_int``) and the
    DownCom (``quantize_down``).  A tree whose ``pack_int`` takes
    ``runs`` gets the plan's whole-run flags.  ms per call (CUDA events,
    5 calls after a warm-up)."""
    import inspect

    import torch
    from repro_torch.dist import comm_ws, sharding, tamuna_dp
    from repro_torch.kernels import wire_pack

    cuda_ms, N = smoke["cuda_ms"], smoke["N"]
    cfg = smoke["TWO_LAYERS"]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=smoke["GAMMA"], c=smoke["C"],
                                      s=smoke["S"], p=smoke["P"])
    mp = smoke["TP_MP"]
    mesh = smoke["tp_mesh_like"](mp, 0)
    spec = tamuna_dp.state_spec(cfg, tcfg, mesh)
    gspec = tamuna_dp.state_spec(cfg, tcfg)
    coords = tamuna_dp.block_coords(cfg, spec, mesh, dev)
    band = comm_ws.band_of_blocks(spec.dims, gspec.dims, coords, "cyclic",
                                  smoke["C"], smoke["S"], dev)
    plan = comm_ws.wire_plan(spec.dims, "auto", smoke["C"], smoke["S"],
                             band, ids=spec.ids, gdims=gspec.dims,
                             coords=coords)
    grp = next(g for g in plan if g.kind == "int8")
    del plan, band, coords
    shape, split = WIRE_AT_GENERAL
    kg = sharding.shard_coords(shape, split, mp, 0).to(dev)
    flags = "runs" in inspect.signature(wire_pack.pack_int).parameters
    g = torch.Generator(device=dev).manual_seed(7)
    for tag, d, make in (
            ("comm_tp", spec.d_total, lambda: grp),
            ("runs_300", kg.numel(), lambda: comm_ws.WireGroup(
                kind="int8", leaves=((0, 0, kg.numel()),),
                leaf_lo=(0, kg.numel()), band=torch.empty(0), whole=False,
                gdims=(shape[0] * shape[1],), coords=kg, runs=(False,)))):
        grp_ = make()
        x = torch.randn(N, d, generator=g, device=dev)
        x[0, ::1000] = float("inf")
        x[2, 500::1000] = float("-inf")
        x[3, 7::999_983] = float("nan")
        row = x[-1].clone()
        scales = comm_ws._group_scales(x, grp_)
        dscales = comm_ws._group_scales(row[None], grp_)
        kw = dict(coords=grp_.coords, gdims=grp_.gdims)
        if flags:
            kw["runs"] = grp_.runs
        dg = grp_.leaf_lo[-1]
        for name, fn in (
                ("scales", lambda: comm_ws._group_scales(x, grp_)),
                ("scales_down", lambda: comm_ws._group_scales(row[None],
                                                              grp_)),
                ("quantize_up", lambda: wire_pack.pack_int(
                    x, grp_.leaves, "int8", 0x5EED, scales=scales, **kw)),
                ("quantize_down", lambda: wire_pack.quantize_down(
                    row, grp_.leaves, "int8", 0x5EED, scales=dscales,
                    **kw))):
            ms = cuda_ms(fn, 5)
            rows = 1 if name.endswith("down") else N
            print(f"[domain] wire_at {tag} {name} ({rows}, {dg}): {ms:.4f} "
                  f"ms", flush=True)
        del x, row, scales, dscales, grp_
        torch.cuda.empty_cache()


# the table forms' general case (chip_smoke.WIRE_AT_GENERAL)
WIRE_AT_GENERAL = ((262144, 600), (False, True))

CHILD = r"""
import os, runpy, sys
import torch
tree = os.getcwd()
sys.path.insert(0, os.path.join(tree, "src"))
smoke = runpy.run_path(os.path.join(tree, "chip_smoke.py"), run_name="phase")
import dataclasses
from repro_torch.configs import gemma2_2b
from repro_torch.dist import tamuna_dp
smoke["tamuna_dp"] = tamuna_dp
smoke["TWO_LAYERS"] = dataclasses.replace(gemma2_2b.CONFIG, n_layers=2)
from repro_torch.kernels import _build

phases = runpy.run_path(sys.argv[1], run_name="phases")
smoke["time_domain"] = lambda dev: phases["time_domain"](smoke, dev)
smoke["time_wire_at"] = lambda dev: phases["time_wire_at"](smoke, dev)
path, secs, _ = _build.build()
print(f"[build] {os.path.relpath(path, tree)} in {secs:.1f} s", flush=True)
_build.load()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for call in sys.argv[2:]:
    eval(call, smoke, {"dev": torch.device("cuda", 0)})
    sys.stdout.flush()
"""

ROUND = re.compile(r"^\[(\w+)\] round (\d+): L=(\d+) loss \S+ wall "
                   r"([\d.]+) s")
PEAK = re.compile(r"^\[(\w+)\] max_memory_allocated \d+ B \(([\d.]+) "
                  r"GiB\)")
DOMAIN = re.compile(r"^\[domain\] (.*): ([\d.]+) ms$")
STEPS = re.compile(r"^\[(\w+)\] \d+ decode steps: prefill .*?\(([\d.]+) ms "
                   r"per step\), generation .*?\(([\d.]+) ms per step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout holding chip_smoke.py and src/; one "
                         "process each, in order")
    ap.add_argument("--phase", action="append", required=True,
                    choices=sorted(PHASES))
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[card] {card.stdout.strip()}", flush=True)
    rows, rc = [], 0
    trains, peaks, domain = {}, {}, []
    for i, tree in enumerate(args.tree):
        print(f"[process {i}] {tree}: {' '.join(args.phase)}", flush=True)
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.abspath(__file__),
             *(PHASES[p] for p in args.phase)],
            cwd=os.path.abspath(tree), capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-4000:])
            print(f"[process {i}] exit {proc.returncode}")
            rc = 1
        lines = proc.stdout.splitlines()
        rows += [(i, tree, *m.groups()) for m in map(STEPS.match, lines)
                 if m]
        for m in filter(None, map(ROUND.match, lines)):
            if m.group(3) == "1":
                trains.setdefault((i, tree, m.group(1)), []).append(
                    m.group(4))
        for m in filter(None, map(PEAK.match, lines)):
            peaks[i, tree, m.group(1)] = m.group(2)
        domain += [(i, tree, *m.groups()) for m in map(DOMAIN.match, lines)
                   if m]
    print("[summary] process, tree, path, prefill ms per step, generation "
          "ms per step")
    for row in rows:
        print("[summary] " + ", ".join(map(str, row)))
    print("[summary] process, tree, kernel and shape, ms per call")
    for row in domain:
        print("[summary] " + ", ".join(map(str, row)))
    print("[summary] process, tree, path, L=1 round seconds, peak GiB")
    for key in sorted(set(trains) | set(peaks)):
        print("[summary] " + ", ".join(map(str, key)) + ", "
              + " ".join(trains.get(key, [])) + ", " + peaks.get(key, "-"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
