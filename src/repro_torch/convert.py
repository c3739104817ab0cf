"""The weight carrier: reference parameters in, port parameters out, and
back (``params_to_numpy``), in the model's ``param_dtype``.

The reference names its leaves ``checkpoint._flatten_with_names`` style
(``blocks/attn/wq``, ``embed``, ``final_norm/scale``) and saves a checkpoint
directory as ``arrays.npz`` (``leaf_<i>`` in leaf order, bf16 stored as its
raw uint16 bits) plus ``meta.json`` (``names``, ``dtypes``, ``shapes``).
Both are read here with numpy and json alone.

A decode cache comes across with ``cache_from_numpy`` (the reference's
arrays of any family, bf16 or f32), so a parity test can start
mid-sequence.

The convex core's problems and states come across as numpy arrays too:
``convex_problem_from_numpy`` (the data, ``mu``, ``L``, ``x*``, ``f*``) and
``tamuna_state_from_numpy`` (``x_bar``, ``h`` and the counters).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import problems, tamuna
from repro_torch.dist.model_api import param_specs
from repro_torch.models.transformer import ModelConfig


def _bf16_bits_to_f32(a: np.ndarray) -> np.ndarray:
    """bf16 stored as raw uint16 bits -> the same values in f32."""
    return (a.astype(np.uint32) << 16).view(np.float32)


def read_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """``{name: array}`` of a reference checkpoint directory, bf16 leaves
    widened to f32 (exactly)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    out: Dict[str, np.ndarray] = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, (name, dtype) in enumerate(zip(meta["names"],
                                              meta["dtypes"])):
            a = z[f"leaf_{i}"]
            if dtype == "bfloat16":
                a = _bf16_bits_to_f32(a)
            if list(a.shape) != list(meta["shapes"][i]):
                raise ValueError(f"leaf {name!r}: shape {a.shape} != "
                                 f"recorded {meta['shapes'][i]}")
            out[name] = a
    return out


def _to_f32(a: np.ndarray) -> np.ndarray:
    """An f32 array of ``a``'s values: numpy's ``bfloat16`` extension type
    widened exactly through its bits, any other float type by numpy."""
    if a.dtype.name == "bfloat16":
        return _bf16_bits_to_f32(np.ascontiguousarray(a).view(np.uint16))
    return a.astype(np.float32)


def params_from_numpy(arrays: Mapping[str, np.ndarray], cfg: ModelConfig,
                      device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The port's parameters in ``cfg.param_dtype`` from reference-named
    numpy arrays (f32, or bf16 as numpy's ``bfloat16`` extension type, as
    a ``param_dtype=bfloat16`` reference init gives them); the names and
    shapes must be exactly the model's.  A bf16 leaf into a bf16 model
    comes across bit for bit."""
    dev = resolve_device(device)
    specs = param_specs(cfg)
    want = [name for name, _ in specs]
    if sorted(arrays) != sorted(want):
        missing = sorted(set(want) - set(arrays))
        extra = sorted(set(arrays) - set(want))
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for name, shape in specs:
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape}, want {shape}")
        out[name] = torch.from_numpy(_to_f32(a)).to(
            device=dev, dtype=cfg.param_dtype)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """The port's parameters as reference-named numpy arrays, the other
    way: f32 leaves as float32, bf16 leaves as their raw uint16 bits (the
    reference checkpoint's storage of bf16; ``.view`` them as a
    ``bfloat16`` type to hand them to the reference)."""
    out = {}
    for name, t in params.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[name] = t.view(torch.int16).numpy().view(np.uint16)
        elif t.dtype == torch.float32:
            out[name] = t.numpy()
        else:
            raise ValueError(f"{name}: dtype {t.dtype}, want float32 or "
                             "bfloat16")
    return out


# the cache's arrays per family (``transformer.init_cache``,
# ``encdec.init_cache``)
CACHE_KEYS = (("k", "v"), ("shift_cm", "shift_tm", "wkv"),
              ("conv", "k", "ssm", "v"), ("k", "v", "xk", "xv"))


def cache_from_numpy(arrays: Mapping[str, np.ndarray],
                     device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The port's decode cache from the reference's arrays: ``{"k", "v"}``
    ``(n_attn, batch, max_seq, kv_heads, head_dim)`` (dense, MoE),
    ``{"shift_tm", "shift_cm", "wkv"}`` (RWKV), ``{"conv", "ssm", "k",
    "v"}`` (the Mamba2 hybrid) or ``{"k", "v", "xk", "xv"}`` (the
    encoder-decoder; ``xk``/``xv`` ``(n_layers, batch, n_frames,
    kv_heads, head_dim)``).  bf16 (numpy's ``bfloat16`` extension
    type) stays bf16, f32 stays f32, bit for bit."""
    dev = resolve_device(device)
    if tuple(sorted(arrays)) not in CACHE_KEYS:
        raise ValueError(f"want the arrays of one of {CACHE_KEYS}, got "
                         f"{sorted(arrays)}")
    out = {}
    for name in arrays:
        a = np.asarray(arrays[name])
        if a.dtype.name == "bfloat16":
            bits = np.ascontiguousarray(a).view(np.uint16)
            out[name] = torch.from_numpy(_bf16_bits_to_f32(bits)).to(
                device=dev, dtype=torch.bfloat16)
        elif a.dtype == np.float32:
            out[name] = torch.tensor(a, device=dev)
        else:
            raise ValueError(f"cache {name}: dtype {a.dtype}, want bfloat16 "
                             "or float32")
    if "k" in out and (out["k"].shape != out["v"].shape
                       or out["k"].dim() != 5):
        raise ValueError(f"k {tuple(out['k'].shape)} and v "
                         f"{tuple(out['v'].shape)} must be one 5-d shape")
    return out


def convex_problem_from_numpy(arrays: Mapping[str, np.ndarray], *, mu: float,
                              L: float, x_star: Optional[np.ndarray] = None,
                              f_star: Optional[float] = None,
                              name: str = "problem",
                              device: DeviceLike = "cuda"
                              ) -> problems.FiniteSumProblem:
    """The port's float64 problem from the reference's data: ``{"A": (n, m,
    d), "b": (n, m)}`` (logistic regression) or ``{"diag": (d,), "t": (n,
    d)}`` (quadratics), with the reference's constants."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=problems.F64, device=dev)

    common = dict(mu=float(mu), L=float(L), name=name,
                  x_star=None if x_star is None else t(x_star),
                  f_star=None if f_star is None else float(f_star))
    if sorted(arrays) == ["A", "b"]:
        n, _, d = np.shape(arrays["A"])
        return problems.LogRegProblem(n=n, d=d, A=t(arrays["A"]),
                                      b=t(arrays["b"]), **common)
    if sorted(arrays) == ["diag", "t"]:
        n, d = np.shape(arrays["t"])
        return problems.QuadraticProblem(n=n, d=d, diag=t(arrays["diag"]),
                                         t=t(arrays["t"]), **common)
    raise ValueError(f"want arrays A, b or diag, t; got {sorted(arrays)}")


def tamuna_state_from_numpy(x_bar: np.ndarray, h: np.ndarray, round: int = 0,
                            total_local_steps: int = 0,
                            up_floats: float = 0.0, down_floats: float = 0.0,
                            device: DeviceLike = "cuda"
                            ) -> tamuna.TamunaState:
    """The port's convex state from the reference's arrays and counters."""
    dev = resolve_device(device)
    return tamuna.TamunaState(
        x_bar=torch.tensor(np.asarray(x_bar), dtype=problems.F64, device=dev),
        h=torch.tensor(np.asarray(h), dtype=problems.F64, device=dev),
        round=int(round), total_local_steps=int(total_local_steps),
        up_floats=float(up_floats), down_floats=float(down_floats))
