#!/usr/bin/env python3
"""Named phases of ``chip_smoke.py``, from one or more checkouts of the
repo, each checkout in a fresh process in the order given, on one CUDA
device: to compare two trees on one card (parent, change, change, parent)
or to rerun a phase alone.  Each checkout builds its kernels under its own
tree at its first process.  Each process prints the phases' own lines;
a summary of every ``[tag] N decode steps`` reading (prefill and
generation ms per step) by process follows.

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
}

CHILD = r"""
import os, runpy, sys
import torch
tree = os.getcwd()
sys.path.insert(0, os.path.join(tree, "src"))
smoke = runpy.run_path(os.path.join(tree, "chip_smoke.py"), run_name="phase")
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
        rows += [(i, tree, *m.groups()) for m in
                 map(STEPS.match, proc.stdout.splitlines()) if m]
    print("[summary] process, tree, path, prefill ms per step, generation "
          "ms per step")
    for row in rows:
        print("[summary] " + ", ".join(map(str, row)))
    return rc


if __name__ == "__main__":
    sys.exit(main())
