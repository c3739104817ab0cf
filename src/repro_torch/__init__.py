"""TAMUNA-DP on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors ``repro``'s layout (``configs/``, ``models/``,
``kernels/``, ``dist/``, ``data/``, ``launch/``) so each module's
counterpart is easy to find, but it imports neither ``jax`` nor anything
of ``repro``: the numpy-only pieces it needs are copied here.

Every entry point takes ``device=`` and defaults to ``"cuda"``; the CPU is
used only when the caller asks for it (``device="cpu"``), and a default
call without a GPU raises (``repro_torch._device.resolve_device``).

The training round (``dist/rounds.py``) reaches three hand-written CUDA
kernels (``kernels/csrc/tamuna_kernels.cu``): the owner-masked UpCom
``masked_sum``, the control-variate update + DownCom ``h_update`` and the
local step ``fused_local_step``.  On a CPU tensor each wrapper runs its
plain PyTorch version (``kernels/ref.py``) instead.
"""

__version__ = "0.1.0"
