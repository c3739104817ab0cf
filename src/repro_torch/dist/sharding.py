"""Data and model parallelism over ranks (``repro.dist.sharding``).

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

The model axis (ROADMAP A9b) is the reference's ``("data", "model")``
mesh on ``dp x mp`` ranks, row-major: rank ``r`` is data index ``r // mp``
and model index ``r % mp`` (``Mesh2D``).  Each parameter leaf is split
over the model axis by the reference's rules on its name and shape
(``leaf_pspec``, ``params_pspecs``: a spec is, per dim, whether the dim is
split); a rank holds the block ``local_shape`` of each leaf, whose
coordinates in the whole leaf ``shard_coords`` gives (row-major over the
global dims, as the reference's ``comm_ws._shard_coords``), so the comm
step's bands and the wire's draws are those of the unsharded leaf.  The
data axis's sums run over the data group (``Mesh2D.rows``), the
tensor-parallel layers' over the model group (``Mesh2D.tp``).

The serving specs (``cache_pspecs``, the prefill and decode inputs) wait
for ROADMAP A9c, with the other families' tensor-parallel layers.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.tensor_parallel import TensorParallel

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


# --------------------------------------------------------------------------
# the model axis: the reference's parameter rules and the 2-D mesh
# --------------------------------------------------------------------------

# leaves that carry a leading stacked-layer axis, never split (it is
# iterated over)
STACKED_KEYS = ("blocks", "enc_blocks", "dec_blocks")
# names whose output feature dim (the last) is split: column parallel
COL_PARALLEL = ("wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up",
                "lm_head", "prefix_proj", "router")
# names whose input feature dim (-2) is split: row parallel, the
# contraction of a column-parallel producer
ROW_PARALLEL = ("wo", "w_down")

Spec = Tuple[bool, ...]


def _div(dim: int, m: int) -> bool:
    return m > 1 and dim >= m and dim % m == 0


def leaf_pspec(name: str, shape: Sequence[int], msize: int,
               moe_expert_parallel: bool = True) -> Spec:
    """Which dims of a parameter leaf ``name`` (``blocks/attn/wq``) of
    ``shape`` are split over ``msize`` model ranks: the reference's
    ``sharding._leaf_pspec``.  Embeddings split the vocab dim; MoE expert
    stacks the expert dim (``moe_expert_parallel``, training) or a feature
    dim; the column-parallel names their last dim, the row-parallel names
    dim -2; any other matrix its last divisible dim of the last two;
    norms, scalars and the stacked-layer axis never.  A dim splits only
    where ``msize`` divides it."""
    shape = tuple(int(d) for d in shape)
    spec = [False] * len(shape)
    if msize <= 1 or not shape:
        return tuple(spec)
    keys = name.split("/")
    off = 1 if any(k in keys for k in STACKED_KEYS) else 0
    nd = len(shape) - off
    if "embed" in keys and nd == 2:
        if _div(shape[off], msize):
            spec[off] = True
        return tuple(spec)
    if "moe" in keys and nd == 3:
        if moe_expert_parallel and _div(shape[off], msize):
            spec[off] = True
            return tuple(spec)
        f_dim = off + 2 if ("w_gate" in keys or "w_up" in keys) else off + 1
        if _div(shape[f_dim], msize):
            spec[f_dim] = True
        return tuple(spec)
    if (any(k in keys for k in COL_PARALLEL) and nd >= 1
            and _div(shape[-1], msize)):
        spec[-1] = True
        return tuple(spec)
    if (any(k in keys for k in ROW_PARALLEL) and nd >= 2
            and _div(shape[-2], msize)):
        spec[-2] = True
        return tuple(spec)
    if nd >= 2:
        for dim in (len(shape) - 1, len(shape) - 2):
            if _div(shape[dim], msize):
                spec[dim] = True
                break
    return tuple(spec)


def params_pspecs(cfg, msize: int, moe_expert_parallel: bool = True
                  ) -> Dict[str, Spec]:
    """``{name: spec}`` of every parameter of ``cfg``
    (``model_api.param_specs``) on ``msize`` model ranks (the reference's
    ``params_pspecs``; the client-stacked state's specs add the data axis
    in front, ``stacked_params_pspecs``)."""
    from repro_torch.dist import model_api

    return {name: leaf_pspec(name, shape, msize, moe_expert_parallel)
            for name, shape in model_api.param_specs(cfg)}


def local_shape(shape: Sequence[int], spec: Spec,
                msize: int) -> Tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    return tuple(int(d) // msize if sp else int(d)
                 for d, sp in zip(shape, spec))


def block_slices(shape: Sequence[int], spec: Spec, msize: int,
                 m_rank: int) -> Tuple[slice, ...]:
    """The index of model rank ``m_rank``'s block in the whole leaf."""
    out = []
    for d, sp in zip(shape, spec):
        loc = int(d) // msize if sp else int(d)
        a = m_rank * loc if sp else 0
        out.append(slice(a, a + loc))
    return tuple(out)


def shard_coords(shape: Sequence[int], spec: Spec, msize: int,
                 m_rank: int, device=None) -> Optional[torch.Tensor]:
    """``(d_local,)`` int64 on ``device`` (default the CPU): the global
    flat coordinate of each element of model rank ``m_rank``'s block,
    row-major over the global dims (the reference's
    ``comm_ws._shard_coords``); ``None`` where the block is the whole leaf
    (the static tables apply).  Made on ``device`` in one broadcast sum,
    so a block of a full-width leaf takes no host pass."""
    shape = tuple(int(d) for d in shape)
    loc = local_shape(shape, spec, msize)
    if loc == shape:
        return None
    sl = block_slices(shape, spec, msize, m_rank)
    k = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        idx = torch.arange(sl[d].start, sl[d].stop, dtype=torch.int64,
                           device=device) * stride
        k = idx.reshape((-1,) + (1,) * k.dim()) + k
        stride *= shape[d]
    return k.reshape(-1)


@dataclasses.dataclass
class Mesh2D:
    """Rank ``rank`` of a ``dp x mp`` mesh, the reference's ``("data",
    "model")`` in row-major order: data index ``rank // mp``, model index
    ``rank % mp``.  ``rows`` is the rank's ``RankRows`` of the population
    over its data group (the ranks of its model index), ``tp`` its
    ``TensorParallel`` over its model group (the ranks of its data
    index)."""

    dp: int
    mp: int
    rank: int
    rows: RankRows
    tp: TensorParallel

    @property
    def d_index(self) -> int:
        return self.rank // self.mp

    @property
    def m_index(self) -> int:
        return self.rank % self.mp


def make_mesh(n: int, dp: int, mp: int) -> Mesh2D:
    """The ``dp x mp`` mesh of the initialised default group (its size must
    be ``dp * mp``) over a population of ``n``: every rank creates every
    data group, then every model group, in the same order
    (``torch.distributed.new_group``), and keeps its own."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ValueError(f"a {dp} x {mp} mesh needs {dp * mp} ranks, the "
                         f"group has {world}")
    data_pg = model_pg = None
    for m in range(mp):
        pg = dist.new_group([m + mp * d for d in range(dp)])
        if m == rank % mp:
            data_pg = pg
    for d in range(dp):
        pg = dist.new_group([d * mp + m for m in range(mp)])
        if d == rank // mp:
            model_pg = pg
    return Mesh2D(dp, mp, rank,
                  RankRows(n, dp, rank // mp, data_pg),
                  TensorParallel(model_pg, rank % mp, mp))


def split_group(group) -> Tuple[Optional[RankRows], Optional[Mesh2D]]:
    """``(data rows, mesh)`` of a ``group=`` argument: a ``RankRows`` (the
    data axis alone), a ``Mesh2D`` or ``None``."""
    if isinstance(group, Mesh2D):
        return group.rows, group
    return group, None


# the split dim of each leaf of the dense family's tensor-parallel layers
# (by its name's last two components); any other leaf is replicated
_TP_DIMS = {"attn/wq": -1, "attn/wk": -1, "attn/wv": -1, "attn/bq": -1,
            "attn/bk": -1, "attn/bv": -1, "attn/wo": -2, "mlp/w_gate": -1,
            "mlp/w_up": -1, "mlp/w_down": -2}


def check_model_parallel(cfg, mp: int) -> None:
    """Raise ``ValueError`` (naming ROADMAP A9c) unless the tensor-parallel
    layers take ``cfg`` on ``mp`` model ranks: the dense family without a
    prefix, whole query and kv heads on every rank, and the rules
    (``params_pspecs``) splitting every projection the Megatron way, the
    vocab of the embedding (and of an untied head) and nothing else."""
    if mp == 1:
        return
    if cfg.family != "dense":
        raise ValueError(f"model parallelism of the {cfg.family} family "
                         "(its tensor-parallel layers) is ROADMAP A9c")
    if cfg.prefix_len:
        raise ValueError("model parallelism with a prefix frontend is "
                         "ROADMAP A9c")
    if cfg.n_heads % mp or cfg.n_kv_heads % mp:
        raise ValueError(
            f"{cfg.n_heads} query and {cfg.n_kv_heads} kv heads do not "
            f"split into {mp} model ranks whole: the rules split head_dim "
            "there (flash_t_shard_axis), ROADMAP A9c")
    from repro_torch.dist import model_api

    for name, shape in model_api.param_specs(cfg):
        spec = leaf_pspec(name, shape, mp)
        want = [False] * len(shape)
        key = "/".join(name.split("/")[-2:])
        if key in _TP_DIMS:
            want[_TP_DIMS[key]] = True
        elif name == "embed":
            want[0] = True
        elif name == "lm_head":
            want[-1] = True
        if tuple(want) != spec:
            raise ValueError(
                f"the rules split {name} {tuple(shape)} as {spec} on {mp} "
                "model ranks, which the dense tensor-parallel layers do "
                "not take: ROADMAP A9c")
