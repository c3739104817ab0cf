"""Build and bind the CUDA kernels of ``csrc/`` (nvcc + ctypes).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``kernels/build/`` (listed in
``.gitignore``), named by a hash of the source so an edited source builds
anew, and loaded with ``ctypes``.  Nothing is built or loaded when the
module is imported: the CPU tests import every module on machines without
``nvcc``.

Launch counts live here too: each wrapper adds one to its kernel's count
where it launches the kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from typing import Dict, Sequence, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "tamuna_kernels.cu")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the kernels agree bitwise with the plain versions
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

# one count per kernel instantiation: the UpComs per lane type, robust_sum
# for s <= 16 and above, h_update in both forms up to 4096 rows and above,
# the int wire's coordinate-table forms (``_at``, model-sharded blocks),
# compress per float type and rank, decode attention per query and cache
# type (bf16 queries on a bf16 cache, f32 queries on an f32 or a bf16 cache)
KERNELS = ("masked_sum", "masked_sum_f16", "masked_sum_bf16",
           "masked_sum_counts", "masked_sum_counts_f16",
           "masked_sum_counts_bf16", "masked_sum_dequant",
           "masked_sum_dequant_counts", "masked_sum_dequant_at",
           "masked_sum_dequant_counts_at", "robust_sum", "robust_sum_large_s",
           "h_update", "h_update_covered", "h_update_large_n",
           "h_update_covered_large_n", "fused_local_step", "wire_quantize",
           "wire_quantize_at",
           "compress_f64", "compress_f32", "compress_1d_f64",
           "compress_1d_f32", "decode_attention", "decode_attention_f32",
           "decode_attention_f32_bf16kv")
launch_counts: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH); cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libtamuna_kernels_{digest}.so")


def build() -> Tuple[str, float, str]:
    """Compile the library unless it is already built; returns
    ``(path, seconds spent compiling, nvcc's and ptxas' report)``.  The
    output is written under a temporary name and renamed, so concurrent
    builders never load a half-written file."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the library, with every C signature set."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
        ctypes.c_float
    lib.tamuna_masked_sum.argtypes = [p, i32, p, p, p, i64, i64, i64, i32,
                                      i32, p]
    lib.tamuna_masked_sum_counts.argtypes = [p, i32, p, p, p, p, i64, i64,
                                             i64, i32, i32, p]
    lib.tamuna_masked_sum_dequant.argtypes = [p, p, i64, p, p, i32, p, p, p,
                                              p, p, i64, i64, i32, i32, i32,
                                              p]
    lib.tamuna_wire_quantize.argtypes = [p, i64, i64, p, p, i32, i64,
                                         ctypes.c_uint32, f32, p, i64, p, i64,
                                         p, i32, i64, p, p, i64, p, p]
    pi = ctypes.POINTER(ctypes.c_int)
    lib.tamuna_robust_sum.argtypes = [p, p, p, p, p, i64, i64, i64, i32,
                                      i32, i32, i32, p, i64, p, pi]
    lib.tamuna_robust_sum_scratch.argtypes = [i64, i64, i32]
    lib.tamuna_robust_sum_scratch.restype = i64
    lib.tamuna_h_update_scratch.argtypes = [i64]
    lib.tamuna_h_update_scratch.restype = i64
    lib.tamuna_h_update.argtypes = [p, p, p, p, p, p, i64, i64, i64, i32,
                                    i32, f32, p, p, pi]
    lib.tamuna_h_update_covered.argtypes = [p, p, p, p, p, p, p, i64, i64,
                                            i64, i32, i32, f32, p, p, pi]
    lib.tamuna_local_step.argtypes = [p, p, p, p, i64, f32, p]
    lib.tamuna_compress.argtypes = [p, i32, p, p, i64, i64, i32, i32, p]
    lib.tamuna_decode_attention.argtypes = [p, i32, p, p, i32, p, p, p, i32,
                                            i32, i32, i32, i64, i64, i64,
                                            i32, i64, f32, f32, p]
    for fn in (lib.tamuna_masked_sum, lib.tamuna_masked_sum_counts,
               lib.tamuna_masked_sum_dequant, lib.tamuna_wire_quantize,
               lib.tamuna_robust_sum, lib.tamuna_h_update,
               lib.tamuna_h_update_covered, lib.tamuna_local_step,
               lib.tamuna_compress, lib.tamuna_decode_attention):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def device_table(values: Tuple[int, ...], device: torch.device
                 ) -> torch.Tensor:
    """``values`` as an int64 tensor on ``device``, made once per
    ``(values, device)``: a kernel's leaf table, which the kernels only
    read.  A CUDA copy is uploaded from pinned memory without a
    synchronisation, so a wrapper that builds its tables on the host never
    waits for the card."""
    host = torch.tensor(values, dtype=torch.int64)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise on a refused launch; count the ones that went through."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launch_counts[name] += 1


def check_variant_launch(names: Sequence[str], rc: int,
                         variant: ctypes.c_int) -> None:
    """``check_launch`` for a C entry that picks its kernel by size and
    reports the one it launched: ``names[variant]``, or none at -1 (an
    empty input, nothing launched or counted)."""
    if variant.value < 0:
        if rc != 0:
            raise RuntimeError(f"{names[0]} kernel launch failed: CUDA "
                               f"error {rc}")
        return
    check_launch(names[variant.value], rc)
