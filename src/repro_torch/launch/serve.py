"""Batched serving driver of the port (``repro.launch.serve``, one device):
prefill by stepping the decode path, then greedy decoding.

The parameters are cast to the compute dtype once
(``serve_utils.cast_for_serving_``) and the cache is bf16, as the
reference's driver makes it.  Attention goes through ``decode_attention``
with each layer's window and the config's softcap
(``kernels.decode_attn.make_attend_fn``): the CUDA kernel on the card, its
plain version on the CPU; RWKV-6 has no attention, and the Mamba2
hybrid attends once per group of layers.  There is no mesh: the reference's
``--data-parallel``/``--model-parallel`` have no counterpart here.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --batch 2 \\
      --prompt-len 8 --gen-len 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --reduced --batch 2 --prompt-len 8 --gen-len 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --reduced --batch 2 --prompt-len 8 --gen-len 4 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import numpy as np
import torch


def make_prompts(batch: int, prompt_len: int, vocab: int, seed: int,
                 device) -> torch.Tensor:
    """Random prompts ``(batch, prompt_len)`` from a numpy stream seeded
    with ``seed + 1`` (the reference draws them with threefry)."""
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, vocab, size=(batch, prompt_len))
    return torch.from_numpy(toks).to(device)


def run(params: Dict[str, torch.Tensor], cfg, prompts: torch.Tensor,
        gen_len: int, *, kv_dtype: torch.dtype = torch.bfloat16,
        attend_fn=None) -> dict:
    """Serve one batch through ``serve_utils.generate``, greedy:
    ``prompt_len`` decode steps over the prompts, then ``gen_len`` greedy
    ones (the last token's step writes its cache row, as the reference's
    loop does).  Returns the generated ``tokens (b, gen_len)``, the last
    ``logits``, the ``cache``, whether every step's logits were finite
    (``finite``) and the wall times (``prefill_s``, ``decode_s``, each
    ending in a device synchronisation)."""
    from repro_torch.dist import model_api
    from repro_torch.serve_utils import generate

    b, plen = prompts.shape
    dev = prompts.device
    cache = model_api.make_cache(cfg, b, plen + gen_len, kv_dtype=kv_dtype,
                                 device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    seen = {}

    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def on_step(pos: int, logits: torch.Tensor) -> None:
        finite.logical_and_(torch.isfinite(logits).all())
        seen["logits"] = logits
        if pos == plen - 1:
            seen["prefill_end"] = now()

    t0 = now()
    with torch.no_grad():
        tokens, cache = generate(params, cfg, prompts, gen_len,
                                 temperature=0.0, cache=cache,
                                 attend_fn=attend_fn, on_step=on_step)
    t2 = now()
    t1 = seen["prefill_end"]
    return {"tokens": tokens, "logits": seen["logits"], "cache": cache,
            "finite": bool(finite), "prefill_s": t1 - t0,
            "decode_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    help="an architecture of configs.registry (dense, moe, "
                         "rwkv or mamba_hybrid)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.configs import registry
    from repro_torch.dist import model_api
    from repro_torch.kernels.decode_attn import make_attend_fn
    from repro_torch.serve_utils import cast_for_serving_

    dev = resolve_device(args.device)
    cfg = (registry.get_reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    params = model_api.init(cfg, seed=args.seed, device=dev)
    cast_for_serving_(params, cfg)
    prompts = make_prompts(args.batch, args.prompt_len, cfg.vocab, args.seed,
                           dev)
    out = run(params, cfg, prompts, args.gen_len,
              attend_fn=make_attend_fn(cfg))
    dt = out["prefill_s"] + out["decode_s"]
    max_seq = args.prompt_len + args.gen_len
    print(f"[serve] {args.arch}{' (reduced)' if args.reduced else ''} on "
          f"{dev}: batch {args.batch}, {args.prompt_len}+{args.gen_len} "
          f"tokens/seq, {dt:.3f}s ({args.batch * max_seq / dt:.1f} tok/s; "
          f"decode {args.batch * args.gen_len / out['decode_s']:.1f} tok/s, "
          f"{out['decode_s'] / args.gen_len * 1e3:.3f} ms per step)")
    if not out["finite"]:
        print("[serve] non-finite logits", file=sys.stderr)
        return 1
    print("[serve] sample continuations:", out["tokens"][:2].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
