#!/usr/bin/env python3
"""Named phases of ``chip_smoke.py``, from one or more checkouts of the
repo, each checkout in a fresh process in the order given, on one CUDA
device: to compare two trees on one card (parent, change, change, parent)
or to rerun a phase alone.  Each checkout builds its kernels under its own
tree at its first process.  Each process prints the phases' own lines;
a summary of every ``[tag] N decode steps`` reading (prefill and
generation ms per step) and of every training path's L=1 round seconds
and peak memory by process follows.  The environment passes on, so
``REPRO_DISABLE_FLASH=1 python3 smoke_phases.py --tree . --phase
memory_dense`` gives the memory table's dense rows.

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
}

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
path, secs, _ = _build.build()
print(f"[build] {os.path.relpath(path, tree)} in {secs:.1f} s", flush=True)
_build.load()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for call in sys.argv[1:]:
    eval(call, smoke, {"dev": torch.device("cuda", 0)})
    sys.stdout.flush()
"""

ROUND = re.compile(r"^\[(\w+)\] round (\d+): L=(\d+) loss \S+ wall "
                   r"([\d.]+) s")
PEAK = re.compile(r"^\[(\w+)\] max_memory_allocated \d+ B \(([\d.]+) "
                  r"GiB\)")
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
    trains, peaks = {}, {}
    for i, tree in enumerate(args.tree):
        print(f"[process {i}] {tree}: {' '.join(args.phase)}", flush=True)
        proc = subprocess.run(
            [sys.executable, "-c", CHILD,
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
    print("[summary] process, tree, path, prefill ms per step, generation "
          "ms per step")
    for row in rows:
        print("[summary] " + ", ".join(map(str, row)))
    print("[summary] process, tree, path, L=1 round seconds, peak GiB")
    for key in sorted(set(trains) | set(peaks)):
        print("[summary] " + ", ".join(map(str, key)) + ", "
              + " ".join(trains.get(key, [])) + ", " + peaks.get(key, "-"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
