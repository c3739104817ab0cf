"""Device resolution shared by every entry point of the port.

The rule: the default is the GPU.  The CPU runs only when the caller asks
for it by name; a default call on a machine without CUDA raises instead of
carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present, or names anything but ``cuda``/``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(--device cpu on the command line) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; want cuda or cpu")
    return dev


def upload(host, device: torch.device,
           dtype: Union[torch.dtype, None] = None) -> torch.Tensor:
    """``host`` (a numpy array, a sequence or a CPU tensor) as a tensor on
    ``device``.  A CUDA copy goes from pinned memory without blocking, so
    the caller does not wait for the card (a plain ``.to(device)`` of
    pageable memory synchronises); PyTorch's pinned allocator keeps the
    staging buffer until the copy has run."""
    t = torch.as_tensor(host, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
