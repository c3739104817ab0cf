"""The quantized wire of the comm step (``repro.dist.wire``, DESIGN.md §13).

The permutation sparsifier decides which coordinates travel; the wire
decides how wide they are.  Four wire kinds narrow the UpCom payload: the
``bf16``/``f16`` casts and the unbiased stochastic ``int8``/``int4``
codes with one f32 scale per 256-coordinate chunk; ``auto`` sends leaves
below ``SIZE_THRESHOLD`` coordinates as f16 and the rest as int8.

The stochastic rounding draws from a counter hash of ``(round seed, leaf
index, client row, leaf coordinate)``, a pure elementwise uint32 function,
so every implementation that quantizes the same payload row gets the same
codes.  Here it runs on int64 tensors holding uint32 values: every product
is split so that no int64 product overflows, and masked to 32 bits after
every step.  The quantizer kernel (``kernels/wire_pack.py``) does the same
arithmetic in ``uint32_t``; these functions are its plain counterparts and
agree bitwise with the reference's.

A nonfinite payload is never quantized into a finite value: float kinds
pass it through, int kinds poison the chunk's scale to NaN.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = [
    "WIRE_KINDS",
    "WIRE_POLICIES",
    "CHUNK",
    "SIZE_THRESHOLD",
    "LEVELS",
    "WIDTH_BYTES",
    "DOWN_ROW",
    "WIRE_FOLD",
    "resolve_kind",
    "is_wire",
    "n_chunks",
    "leaf_up_bytes",
    "leaf_down_bytes",
    "fold_seed",
    "uniform01",
    "round_seed",
    "leaf_scales",
    "chunk_max_at",
    "scales_of_max",
    "leaf_scales_at",
    "narrow",
    "quantize",
    "quantize_to_int",
]

WIRE_KINDS = ("f32", "bf16", "f16", "int8", "int4")
WIRE_POLICIES = ("auto",) + WIRE_KINDS

CHUNK = 256                   # coordinates per stochastic-rounding scale
SIZE_THRESHOLD = 2 ** 16 + 1  # auto policy: leaves below this go f16
LEVELS = {"int8": 127, "int4": 7}
WIDTH_BYTES = {"f32": 4.0, "bf16": 2.0, "f16": 2.0, "int8": 1.0, "int4": 0.5}
F_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
F16_MAX = 65504.0             # finite payloads must stay finite on the wire

# pseudo row id of the one shared DownCom quantization
DOWN_ROW = 0xFFFFFFFF

# tag separating the wire stream from the round's other draws
WIRE_FOLD = 0x517E

_M32 = 0xFFFFFFFF
_TWO_M32 = 2.0 ** -32

UInt = Union[int, torch.Tensor]  # a uint32 value: a Python int or int64


def resolve_kind(d: int, policy: Optional[str]) -> str:
    """Wire kind of a leaf of ``d`` coordinates under ``policy``."""
    if policy is None:
        return "f32"
    if policy == "auto":
        return "f16" if d < SIZE_THRESHOLD else "int8"
    if policy not in WIRE_KINDS:
        raise ValueError(
            f"unknown wire policy {policy!r}; expected one of {WIRE_POLICIES}")
    return policy


def is_wire(policy: Optional[str]) -> bool:
    """True iff ``policy`` can change a payload (not the f32 path)."""
    return policy is not None and policy != "f32"


def n_chunks(d: int) -> int:
    return -(-d // CHUNK)


def leaf_up_bytes(nnz: int, d: int, c: int, kind: str) -> float:
    """UpCom bytes of one round for a leaf: ``nnz`` owned coordinates at
    ``kind`` width; int kinds add the per-chunk f32 scales each of the
    ``c`` clients ships beside its codes."""
    b = nnz * WIDTH_BYTES[kind]
    if kind in LEVELS:
        b += c * n_chunks(d) * 4.0
    return float(b)


def leaf_down_bytes(d: int, kind: str) -> float:
    """DownCom bytes of one broadcast of a ``d``-coordinate leaf."""
    b = d * WIDTH_BYTES[kind]
    if kind in LEVELS:
        b += n_chunks(d) * 4.0
    return float(b)


# --------------------------------------------------------------------------
# the counter hash: uint32 arithmetic on Python ints or int64 tensors
# --------------------------------------------------------------------------


def _mul32(a: UInt, b: int) -> UInt:
    """``a * b mod 2**32`` for ``0 <= a < 2**32`` and a constant ``b``:
    each partial product stays below 2**48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _avalanche(h: UInt) -> UInt:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def round_seed(words: Sequence[int]) -> int:
    """The round's uint32 wire seed from a key's uint32 words (the
    reference takes them from ``jax.random.key_data``)."""
    words = [int(w) & _M32 for w in words]
    return int(_avalanche(words[0] ^ _avalanche(words[-1])))


def fold_seed(seed: int, leaf_index: int) -> int:
    """The round seed folded with a leaf's index in the full leaf list, so
    the same (row, coordinate) of two leaves draws independently."""
    return int(_avalanche((int(seed) & _M32)
                          ^ _mul32(int(leaf_index) & _M32, 0x9E3779B9)))


def uniform01(seed: UInt, row_ids: UInt, coord_ids: UInt) -> torch.Tensor:
    """U[0, 1) in f32 keyed on ``(seed, row, coordinate)``; int64 tensors
    of uint32 values, shapes broadcast.  The uint32 hash converts to f32
    with round-to-nearest-even, so a hash near 2**32 gives exactly 1.0."""
    h = _avalanche(seed ^ _mul32(row_ids, 0x9E3779B9))
    h = _avalanche(h ^ _mul32(coord_ids, 0x85EBCA6B))
    return torch.as_tensor(h).to(torch.float32) * _TWO_M32


# --------------------------------------------------------------------------
# per-chunk scales, narrowing, quantization
# --------------------------------------------------------------------------


def leaf_scales(x2: torch.Tensor, kind: str) -> Optional[torch.Tensor]:
    """Per-row per-chunk scales of an int kind: ``(rows, d) -> (rows,
    n_chunks(d))``.  Nonfinite entries are left out of the chunk max; an
    all-zero chunk clamps to 1e-12 so ``0 / scale`` stays exact."""
    if kind not in LEVELS:
        return None
    rows, d = x2.shape
    nc = n_chunks(d)
    a = torch.where(x2.isfinite(), x2.abs(), 0.0)
    pad = nc * CHUNK - d
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
    mx = a.reshape(rows, nc, CHUNK).amax(dim=2)
    floor = torch.tensor(1e-12, dtype=torch.float32, device=x2.device)
    # a tensor divisor: CUDA's division by a Python number multiplies by
    # its reciprocal, one rounding away from the division
    levels = torch.tensor(float(LEVELS[kind]), device=x2.device)
    return torch.maximum(mx / levels, floor)


def chunk_max_at(x2: torch.Tensor, coords: torch.Tensor, nc: int,
                 out: Optional[torch.Tensor] = None,
                 whole_chunks: bool = False) -> torch.Tensor:
    """The per-chunk max of the finite ``|x|`` of a block of a leaf whose
    columns are the leaf coordinates ``coords`` (``(d_local,)`` int64):
    ``(rows, nc)``, or maxed into ``out`` (a ``(rows, nc)`` view of
    non-negative maxima, in place).  Nonfinite entries count as 0.
    ``whole_chunks`` (known on the host): the block is whole
    256-coordinate chunks in order, each a run of 256 columns.  The block
    as a one-leaf group of ``kernels.wire_pack.chunk_max_at``: the kernel
    on the card, ``kernels.ref.chunk_max_at`` on the CPU."""
    from repro_torch.kernels import wire_pack

    return wire_pack.chunk_max_at(
        x2, ((0, 0, x2.shape[1]),), coords=coords, gdims=(nc * CHUNK,),
        runs=(whole_chunks,), out=out)


def scales_of_max(mx: torch.Tensor, kind: str) -> torch.Tensor:
    """``leaf_scales``'s ``max(mx / levels, 1e-12)`` of chunk maxima."""
    floor = torch.tensor(1e-12, dtype=torch.float32, device=mx.device)
    levels = torch.tensor(float(LEVELS[kind]), device=mx.device)
    return torch.maximum(mx / levels, floor)


def leaf_scales_at(x2: torch.Tensor, coords: torch.Tensor, nc: int,
                   kind: str, group=None) -> torch.Tensor:
    """The scatter-max form of ``leaf_scales`` for a model-sharded leaf
    (``repro.dist.wire.leaf_scales_at``): the ``(rows, d_local)`` block
    ``x2`` with its global leaf coordinates ``coords``, ``nc`` the leaf's
    global chunk count; ``group`` (a ``tensor_parallel.TensorParallel``,
    the leaf's model group) maxes the chunk maxima over the blocks, one
    ``all_reduce(MAX)``, which merges the chunks that straddle blocks.
    Max is exact, so the scales are bitwise ``leaf_scales`` of the whole
    leaf.  The comm step maxes a kind group's leaves into one buffer and
    reduces it once (``chunk_max_at``, ``scales_of_max``)."""
    mx = chunk_max_at(x2, coords, nc)
    if group is not None:
        group.all_reduce(mx, "max")
    return scales_of_max(mx, kind)


def narrow(x2: torch.Tensor, kind: str) -> torch.Tensor:
    """The payload cast to the narrow float wire dtype.  f16 clips finite
    values into its range first, so no finite payload becomes inf;
    nonfinite values pass through."""
    y = x2
    if kind == "f16":
        y = torch.where(x2.isfinite(), x2.clamp(-F16_MAX, F16_MAX), x2)
    return y.to(F_DTYPES[kind])


def _codes(x2, sc, seed, row_ids, coord_ids, levels: int) -> torch.Tensor:
    z = x2 / sc
    low = torch.floor(z)
    u = uniform01(seed, row_ids, coord_ids)
    q = low + (u < (z - low)).to(torch.float32)
    return q.clamp(-float(levels), float(levels))


def _chunk_ids(d: int, device) -> torch.Tensor:
    return torch.arange(d, dtype=torch.int64, device=device) // CHUNK


def quantize(x2: torch.Tensor, kind: str, seed: UInt = 0,
             row_ids: UInt = 0, coord_ids: Optional[UInt] = None,
             scales: Optional[torch.Tensor] = None,
             chunk_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize-dequantize a ``(rows, d)`` f32 payload at ``kind``.

    ``row_ids`` (e.g. ``(rows, 1)``) and ``coord_ids`` (default
    ``arange(d)``) key the draw and broadcast against ``x2``; ``scales``
    and ``chunk_ids`` select each coordinate's scale (derived from ``x2``
    when omitted).  Nonfinite inputs pass through."""
    if kind == "f32":
        return x2
    if kind in F_DTYPES:
        return narrow(x2, kind).to(torch.float32)
    d = x2.shape[-1]
    if scales is None:
        scales = leaf_scales(x2, kind)
    if chunk_ids is None:
        chunk_ids = _chunk_ids(d, x2.device)
    if coord_ids is None:
        coord_ids = torch.arange(d, dtype=torch.int64, device=x2.device)
    sc = scales[:, chunk_ids]
    q = _codes(x2, sc, seed, row_ids, coord_ids, LEVELS[kind])
    return torch.where(x2.isfinite(), q * sc, x2)


def quantize_to_int(x2: torch.Tensor, kind: str, seed: UInt, row_ids: UInt,
                    coord_ids: UInt, scales: torch.Tensor,
                    chunk_ids: torch.Tensor):
    """Integer codes of the int wire: ``(codes int8, scales f32)``, int4
    codes within ±7 in the int8 container.  A chunk that holds a nonfinite
    payload gets a NaN scale, so dequantization yields NaN and never a
    finite value minted from it."""
    sc = scales[:, chunk_ids]
    q = _codes(x2, sc, seed, row_ids, coord_ids, LEVELS[kind])
    fin = x2.isfinite()
    q = torch.where(fin, q, 0.0)
    bad = torch.zeros(scales.shape, dtype=torch.float32, device=x2.device)
    bad.index_add_(1, chunk_ids, (~fin).to(torch.float32))
    scales = torch.where(bad > 0, float("nan"), scales)
    return q.to(torch.int8), scales
