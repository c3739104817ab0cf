"""The weight carrier: reference parameters in, port parameters out.

The reference names its leaves ``checkpoint._flatten_with_names`` style
(``blocks/attn/wq``, ``embed``, ``final_norm/scale``) and saves a checkpoint
directory as ``arrays.npz`` (``leaf_<i>`` in leaf order, bf16 stored as its
raw uint16 bits) plus ``meta.json`` (``names``, ``dtypes``, ``shapes``).
Both are read here with numpy and json alone.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
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


def params_from_numpy(arrays: Mapping[str, np.ndarray], cfg: ModelConfig,
                      device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The port's f32 parameters from reference-named numpy arrays; the
    names and shapes must be exactly the model's."""
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
        out[name] = torch.tensor(a, dtype=torch.float32, device=dev)
    return out
