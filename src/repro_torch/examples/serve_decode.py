"""Serving scenario: batched decoding with a cache across model families
(``examples/serve_decode.py`` on the port).

Decodes the reduced rwkv6-7b (a state of constant size), gemma2-2b (a
sliding-window K/V cache) and qwen3-moe-30b-a3b (top-8 routing) through
the serving path of ``repro_torch.dist.model_api``, with attention through
``decode_attention`` (the CUDA kernel on the card, its plain version on
the CPU), and prints each family's cache size and decode throughput.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

ARCHS = ("rwkv6-7b", "gemma2-2b", "qwen3-moe-30b-a3b")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import registry
    from repro_torch.dist import model_api
    from repro_torch.kernels.decode_attn import make_attend_fn

    dev = resolve_device(args.device)
    B, prompt, gen = args.batch, args.prompt_len, args.gen_len

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ok = True
    for arch in ARCHS:
        cfg = registry.get_reduced_config(arch)
        params = model_api.init(cfg, seed=0, device=dev)
        attend = make_attend_fn(cfg)
        cache = model_api.make_cache(cfg, B, prompt + gen,
                                     kv_dtype=torch.float32, device=dev)
        cache_bytes = sum(v.numel() * v.element_size()
                          for v in cache.values())
        toks = torch.randint(0, cfg.vocab, (B, prompt),
                             generator=torch.Generator().manual_seed(1)
                             ).to(dev)
        out = []
        with torch.no_grad():
            # the prompt fed by decoding (untimed: decode throughput, not
            # prompt ingestion, is what this reports)
            for i in range(prompt):
                logits, cache = model_api.decode(
                    params, cfg, toks[:, i:i + 1], cache, i, attend)
            tok = torch.argmax(logits, -1)[:, None]
            sync()
            t0 = time.perf_counter()
            for i in range(prompt, prompt + gen):
                out.append(tok[0, 0])
                logits, cache = model_api.decode(params, cfg, tok, cache, i,
                                                 attend)
                tok = torch.argmax(logits, -1)[:, None]
            sync()
            dt = time.perf_counter() - t0
        ok = ok and bool(torch.isfinite(logits).all())
        grows = ("O(1) in context" if cfg.family == "rwkv"
                 else "O(context) KV")
        print(f"{arch:>20}: cache {cache_bytes / 1e6:6.2f} MB ({grows}), "
              f"{gen * B / dt:6.1f} decode tok/s on {dev}, sample "
              f"{[int(t) for t in out[:6]]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
