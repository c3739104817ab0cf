"""Data parallelism over ranks (``repro.dist.sharding``, the data axis).

The reference places the client axis of the training state on the data
axes of a device mesh: client ``i`` lives on data shard ``i // rows``, with
``rows = ceil(n / dp)`` rows a shard and the axis padded with idle rows to
``rows * dp`` (``comm_ws._shard_comm``).  Here a shard is a
``torch.distributed`` rank: ``RankRows`` is the rank's share of the
population, its process group and the one collective the comm step
needs, a d-sized sum (``all_reduce``).  An idle pad row owns nothing and
receives nothing, so no storage is allocated for it: a rank holds the
real rows ``[row0, min(row0 + rows, n))``, possibly none.

Every collective of the shard engine (``comm_ws.shard_comm``) and of the
round driver (``rounds.run_rounds(group=)``) goes through
``RankRows.all_reduce``, which records each call's element count in
``sizes``, so a caller can hold the engine to its bound: no collective
larger than the workspace's width (``s`` times a column chunk on the
robust combine's owner exchange), never one sized by the population.

Only sums are used, and only ``all_reduce``, which both backends take on
CUDA tensors: ``gloo`` (any device; stages a CUDA tensor through host
memory; the one that runs several ranks on one card) and ``nccl`` (one
card per rank).  The backend is always named by the caller
(``check_backend``); nothing switches one for the other.

The model axis of the reference's mesh (``sharding._leaf_pspec`` and the
parameter rules, the model-sharded bands, ``wire.leaf_scales_at``,
tensor-parallel layers) is not ported: ROADMAP A9b.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class RankRows:
    """Rank ``rank`` of ``world``'s share of a population of ``n`` clients:
    ``rows = ceil(n / world)`` a rank, global rows ``[row0, stop)``.

    ``pg`` is the ``torch.distributed`` process group (``None``: the
    default group; with ``world == 1`` and no group initialised the sums
    are the identity).  ``sizes`` records the element count of every
    ``all_reduce`` issued through this object, in order, and ``seconds``
    the host time each call held its caller (gloo: the whole sum, staged
    through host memory; nccl: the enqueue)."""

    n: int
    world: int
    rank: int
    pg: Any = None
    sizes: List[int] = dataclasses.field(default_factory=list)
    seconds: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.n < 1 or self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"bad RankRows(n={self.n}, world={self.world}, "
                             f"rank={self.rank})")

    @classmethod
    def of_group(cls, n: int, pg: Any = None) -> "RankRows":
        """This process's rows of ``n`` in the initialised group ``pg``."""
        import torch.distributed as dist

        return cls(n, dist.get_world_size(pg), dist.get_rank(pg), pg)

    @property
    def rows(self) -> int:
        """Rows per rank, the reference's padded shard height."""
        return -(-self.n // self.world)

    @property
    def row0(self) -> int:
        return self.rank * self.rows

    @property
    def stop(self) -> int:
        return max(min(self.row0 + self.rows, self.n), self.row0)

    @property
    def local(self) -> int:
        """The real rows this rank holds (0 for a rank of pad rows only)."""
        return self.stop - self.row0

    def hosts(self, i: int) -> bool:
        return self.row0 <= int(i) < self.stop

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place; returns ``t``."""
        import torch.distributed as dist

        self.sizes.append(t.numel())
        t0 = time.perf_counter()
        if self.world > 1 or dist.is_initialized():
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        self.seconds.append(time.perf_counter() - t0)
        return t


def check_backend(backend: str, device: str, world: int) -> None:
    """Raise unless ``backend`` can run ``world`` ranks on ``device``
    (``"cpu"`` or ``"cuda"``): nccl needs a card per rank, the CPU needs
    gloo.  Ranks that share one card pass ``gloo``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"unknown device {device!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; use "
                             "gloo on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"nccl takes one card per rank: {world} ranks, {cards} "
                "cards; ranks that share a card need --dist-backend gloo")


def init_group(backend: str, rank: int, world: int,
               init_method: str) -> None:
    """``torch.distributed.init_process_group`` with everything explicit:
    ``backend`` (``"nccl"`` or ``"gloo"``), this process's ``rank``, the
    ``world`` size and the rendezvous ``init_method`` (``file://...``,
    ``tcp://localhost:<port>`` or ``env://``)."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % cards)`` or the CPU."""
    if device == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device: str, init_method: str, args: Sequence) -> None:
    import torch.distributed as dist

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_group(backend, rank, world, init_method)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str, device: str,
          init_method: str, args: Sequence = ()) -> None:
    """Run ``fn(rank, device, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method: a forked child cannot initialise CUDA), each
    in the group ``init_method`` names, rank ``r`` on ``rank_device(device,
    r)``.  ``fn`` must be importable by name from a fresh interpreter.
    Returns when every rank has exited 0; raises when any rank fails (the
    others are then terminated).  Results travel in files or in what
    ``args`` carries."""
    import torch.multiprocessing as mp

    check_backend(backend, device, world)
    mp.start_processes(_rank_main,
                       args=(fn, world, backend, device, init_method,
                             tuple(args)),
                       nprocs=world, join=True, start_method="spawn")


def file_init_method(directory: str, name: str = "dist_store") -> str:
    """A ``file://`` rendezvous under ``directory`` (created; a stale store
    file of that name is removed): no TCP port is shared with anything
    else on the machine."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name))
    if os.path.exists(path):
        os.unlink(path)
    return "file://" + path


def local_rows(group: Optional[RankRows], n: int) -> slice:
    """The global rows a process holds: the group's, else all ``n``."""
    if group is None:
        return slice(0, n)
    return slice(group.row0, group.stop)
