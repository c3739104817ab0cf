"""Batched serving driver of the port (``repro.launch.serve``, one device):
prefill by stepping the decode path, then greedy decoding.

The parameters are cast to the compute dtype once
(``serve_utils.cast_for_serving_``) and the cache is bf16, as the
reference's driver makes it.  Attention goes through ``decode_attention``
with each layer's window and the config's softcap
(``kernels.decode_attn.make_attend_fn``): the CUDA kernel on the card, its
plain version on the CPU; RWKV-6 has no attention, and the Mamba2
hybrid attends once per group of layers.  The encoder-decoder
(whisper-tiny) serves against frame embeddings drawn from a numpy stream
(the reference draws them from threefry key 7): the encoder runs once and
fills the cross-attention's K/V in the cache, timed apart from the
prefill; its decode step takes no pluggable attention, as the
reference's.  Serving runs on one device: the reference's
``--data-parallel``/``--model-parallel`` for serving are ROADMAP A9c (the
train CLI's ``--data-parallel`` and ``--model-parallel`` are ported).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --batch 2 \\
      --prompt-len 8 --gen-len 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --reduced --batch 2 --prompt-len 8 --gen-len 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --reduced --batch 2 --prompt-len 8 --gen-len 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
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


def make_frames(batch: int, cfg, device) -> torch.Tensor:
    """The encoder-decoder's frame embeddings ``(batch, n_frames,
    d_model)``: f32 normals from a numpy stream seeded with 7 (the
    reference draws them from threefry key 7), cast to the compute
    dtype."""
    rng = np.random.default_rng(7)
    fr = rng.standard_normal((batch, cfg.n_frames, cfg.d_model),
                             dtype=np.float32)
    return torch.from_numpy(fr).to(device=device, dtype=cfg.dtype)


def fill_cross_kv(params: Dict[str, torch.Tensor], cfg, cache,
                  frames: torch.Tensor):
    """The encoder-decoder's cache made ready to decode: ``encode(frames)``
    once, then its cross-attention K/V into the cache, in place."""
    from repro_torch.models import encdec

    with torch.no_grad():
        enc = encdec.encode(params, cfg, frames)
        return encdec.precompute_cross_kv(params, cfg, enc, cache)


def run(params: Dict[str, torch.Tensor], cfg, prompts: torch.Tensor,
        gen_len: int, *, kv_dtype: torch.dtype = torch.bfloat16,
        attend_fn=None, frames=None) -> dict:
    """Serve one batch through ``serve_utils.generate``, greedy:
    ``prompt_len`` decode steps over the prompts, then ``gen_len`` greedy
    ones (the last token's step writes its cache row, as the reference's
    loop does); the encoder-decoder first encodes ``frames`` into the
    cache (``fill_cross_kv``).  Returns the generated ``tokens (b,
    gen_len)``, the last ``logits``, the ``cache``, whether every step's
    logits were finite (``finite``) and the wall times (``encode_s``, 0
    for the other families, ``prefill_s``, ``decode_s``, each ending in a
    device synchronisation)."""
    from repro_torch.dist import model_api
    from repro_torch.serve_utils import generate

    b, plen = prompts.shape
    dev = prompts.device
    if (cfg.family == "encdec") != (frames is not None):
        raise ValueError("frames are the encoder-decoder's input, and only "
                         "its")
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

    t_enc = now()
    if frames is not None:
        fill_cross_kv(params, cfg, cache, frames)
    t0 = now()
    with torch.no_grad():
        tokens, cache = generate(params, cfg, prompts, gen_len,
                                 temperature=0.0, cache=cache,
                                 attend_fn=attend_fn, on_step=on_step)
    t2 = now()
    t1 = seen["prefill_end"]
    return {"tokens": tokens, "logits": seen["logits"], "cache": cache,
            "finite": bool(finite), "encode_s": t0 - t_enc,
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    help="an architecture of configs.registry (dense, moe, "
                         "rwkv, mamba_hybrid or encdec)")
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
    if cfg.family == "encdec":
        out = run(params, cfg, prompts, args.gen_len,
                  frames=make_frames(args.batch, cfg, dev))
        print(f"[serve] encoder and cross K/V over {cfg.n_frames} frames: "
              f"{out['encode_s']:.3f}s")
    else:
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
