"""Single-query GQA decode attention (flash-decode) as one CUDA kernel.

Replaces the Pallas ``repro.kernels.decode_attn.decode_attention``
(``_decode_attn_kernel``, decode_attn.py:33, ``pallas_call`` at :101),
reached from the serving side's decode step.  One new query per sequence
attends to its KV cache: ``q (b, h, hd)`` against ``k, v (b, S, kvh, hd)``,
keys ``pos - window < t <= pos`` visible, an optional logit softcap, query
head ``j`` reading kv head ``j // (h // kvh)``.

Bound by bytes on one H100: every visible K and V row is read once (the
whole query group shares it), so the least time is the visible rows' bytes
over 3.35 TB/s.  The kernel visits only the visible keys and splits them
over enough blocks to fill the card, then merges the splits' partial
softmaxes (``tamuna_kernels.cu``).  The bf16 instantiation streams 16-key
K/V tiles through shared memory with ``cp.async`` and takes the logits and
the weighted sum on the tensor cores (``mma.sync``), two blocks per SM
(``split_plan(..., tiled=True)``); the f32 instantiations keep one key per
warp per step on the CUDA cores.  A CPU tensor runs the plain version
(``ref.decode_attention``); a CUDA tensor launches the kernel or raises.

``make_attend_fn(cfg)`` plugs the kernel into ``transformer.decode_step``,
as ``repro.kernels.ops.make_attend_fn`` does the Pallas kernel, with two
differences that make it serve the configured model: it passes each
layer's window (the reference's adapter drops it, ``del dyn_window``) and
the config's attention softcap (the reference's defaults to none).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

# blocks the f32 kernels aim for: 4 per SM on the H100's 132 (8 warps each)
TARGET_BLOCKS = 528
# the bf16 kernel's: 2 per SM (2 warps and 96 KB of K/V ring each at hd
# 256), never more than fit at once, and 16-key tiles
TILED_BLOCKS = 264
TILE = 16
# fewest keys a block takes: below this a split costs more than it saves
MIN_SPLIT = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# launch-count name per (query dtype, cache dtype)
_NAMES = {
    (torch.bfloat16, torch.bfloat16): "decode_attention",
    (torch.float32, torch.float32): "decode_attention_f32",
    (torch.float32, torch.bfloat16): "decode_attention_f32_bf16kv",
}
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 8


def visible_keys(pos: int, window: Optional[int]) -> Tuple[int, int]:
    """``(lo, n)``: the visible keys are ``lo .. pos``, ``n`` of them.
    Python integers, so a global window of ``int32_max // 2`` cannot
    overflow."""
    lo = 0 if window is None else max(0, pos - window + 1)
    return lo, pos - lo + 1


def split_plan(b: int, kvh: int, n_keys: int,
               tiled: bool = False) -> Tuple[int, int]:
    """``(n_splits, split_len)``: how many blocks share one ``(b, kv
    head)``'s ``n_keys`` keys, and how many keys each takes; no split is
    empty.  ``tiled`` (the bf16 kernel): at most ``TILED_BLOCKS`` blocks in
    all where the pairs allow, so they all run at once, and ``split_len`` a
    multiple of ``TILE``."""
    pairs = b * kvh
    if tiled:
        want, tile = max(1, TILED_BLOCKS // pairs), TILE
    else:
        want, tile = max(1, -(-TARGET_BLOCKS // pairs)), 1
    n_splits = max(1, min(want, -(-n_keys // MIN_SPLIT)))
    per_split = -(-n_keys // n_splits)
    split_len = -(-per_split // tile) * tile
    return -(-n_keys // split_len), split_len


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int,
           window: Optional[int]) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (b, h, hd) and k, v (b, S, kvh, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k.shape)}")
    if not 0 <= pos < k.shape[1]:
        raise ValueError(f"pos {pos} outside the cache's {k.shape[1]} "
                         "positions")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device != k.device or k.device != v.device:
        raise ValueError("q, k and v must be on one device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Attention of the ``(b, h, hd)`` queries at position ``pos`` over the
    ``(b, S, kvh, hd)`` cache; ``(b, h, hd)`` in ``q``'s dtype.  On the
    card: f32 or bf16 queries, an f32 or bf16 cache (bf16 queries need a
    bf16 cache), ``hd`` in ``HEAD_DIMS``, at most ``MAX_GROUP`` query heads
    per kv head, contiguous tensors."""
    pos = int(pos)
    _check(q, k, v, pos, window)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, pos, window=window,
                                    softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, hd = q.shape
    S, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    name = _NAMES.get((q.dtype, k.dtype))
    if name is None or v.dtype != k.dtype:
        raise ValueError(f"no kernel for {q.dtype} queries on a {k.dtype} "
                         f"/ {v.dtype} cache; want one of {list(_NAMES)}")
    if hd not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"head_dim {hd} (want one of {HEAD_DIMS}) or "
                         f"group {group} (want <= {MAX_GROUP}) not taken")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{nm} must be contiguous and 16-byte aligned")
    lo, n_keys = visible_keys(pos, window)
    n_splits, split_len = split_plan(b, kvh, n_keys,
                                     tiled=q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    # the splits' partial accumulators, then their (max, denominator)
    n_part = b * kvh * n_splits * group if n_splits > 1 else 0
    part = torch.empty(n_part * (hd + 2), dtype=torch.float32,
                       device=q.device)
    rc = _build.load().tamuna_decode_attention(
        q.data_ptr(), _DTYPE_CODE[q.dtype], k.data_ptr(), v.data_ptr(),
        _DTYPE_CODE[k.dtype], out.data_ptr(), part.data_ptr(),
        part.data_ptr() + 4 * n_part * hd, b, h, kvh, hd, S, pos, lo,
        n_splits, split_len,
        1.0 / math.sqrt(hd), 0.0 if softcap is None else float(softcap),
        _build.stream_of(q))
    _build.check_launch(name, rc)
    return out


def make_attend_fn(cfg) -> Callable[..., torch.Tensor]:
    """``attend(q, cache_k, cache_v, pos, window) -> (b, 1, h, hd)`` for
    ``transformer.decode_step(..., attend_fn=)``: the kernel with the
    layer's ``window`` and ``cfg.attn_softcap``.  The cache is read in its
    storage dtype (the reference's adapter copies it to ``q``'s dtype
    first; the numbers are the same)."""
    cap = cfg.attn_softcap

    def attend(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
               pos, window: Optional[int] = None) -> torch.Tensor:
        if q.shape[1] != 1:
            raise ValueError("decode attention is single-query")
        out = decode_attention(q[:, 0], cache_k, cache_v, pos,
                               window=window, softcap=cap)
        return out[:, None]

    return attend
