"""TAMUNA-DP on one GPU (``repro.dist.tamuna_dp``): config, state, the
local step, the comm step and the round length.

A round gathers the cohort, runs L local steps on the cohort's rows, then
one compressed comm step: the owner-masked UpCom with the exact ``1/s``
rebuild, the control-variate update on owned coordinates and the DownCom
to the ``down`` rows.

The local step is the paper's ``x <- x - gamma (g - h)`` (``local_opt=
"sgd"``, the ``fused_local_step`` kernel) or an AdamW step with learning
rate ``gamma`` on the h-corrected gradient ``g - h`` (``"adamw"``, plain
torch as the reference's is plain jnp; the moments are two more ``(n,
d_total)`` f32 workspaces and the step count is shared by all clients).
``microbatches`` splits each client's batch and averages the gradients.

The comm step has both templates of the reference: ``uplink=
"masked_psum"`` (the cyclic template, a permutation ``perm`` of its ``c``
columns per round) and ``"block_rs"`` (the blocked template, a shift
``off`` per round), and its ``comm_impl``s: ``"pallas"`` is the port's
CUDA kernel path over the workspaces (``comm_ws.cyclic_comm``/
``blocked_comm``), ``"ws"`` and ``"dense"`` the reference's plain
implementations over the leaf views of the rows
(``comm_ws.iter_comm_leaves``), and ``"auto"`` the kernel path (on a CPU
tensor its plain versions; the reference's ``auto`` is ``ws`` off its
TPU).  A tall-and-thin leaf (``D s < c``) of the cyclic template is laid
after the others in the workspace and takes the dense per-leaf form
(``state_spec``).

Under data parallelism (``sharding.RankRows``, ROADMAP A9a) a rank's
state holds only its rows (``init_state(rows=)``), the local step trains
the cohort members it hosts, and the comm step runs the shard engine
(``make_comm_step(group=)``, ``comm_ws.shard_comm``).  Under model
parallelism (``sharding.Mesh2D``, ROADMAP A9b) a rank's rows hold its
blocks of the leaves (``state_spec(mesh=)``, ``init_state(mesh=)``), the
local step runs the tensor-parallel layers on them
(``make_local_step(mesh=)``), and the comm step runs on the blocks with
their bands and wire tables from the global coordinates
(``make_comm_step(mesh=)``): the one-process kernel step at one data
rank, the shard engine over the data group above.

Randomness is injected: the comm step takes the round's ``cohort``, the
permutation ``perm`` or the shift ``off``, the DownCom rows ``down`` and
the wire seed as arguments (the reference draws them from threefry keys);
``dist/rounds.py`` draws the permutation and the shift from a
``torch.Generator``, the cohorts from a numpy stream or a ``CohortPlan``
and the wire seed from a numpy stream.  The geometric round length is the
reference's numpy draw and ports bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch._device import resolve_device, upload
from repro_torch.core import masks, theory
from repro_torch.dist import comm_ws, model_api, robust, sharding, wire
from repro_torch.dist.sharding import Mesh2D, RankRows
from repro_torch.kernels.local_step import fused_local_step
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import optimizers

__all__ = [
    "COMM_IMPLS",
    "DistTamunaConfig",
    "DistTamunaState",
    "state_spec",
    "init_state",
    "member_mask",
    "gather_cohort",
    "scatter_cohort",
    "make_local_step",
    "make_comm_step",
    "sample_round_length",
    "comm_counters",
    "add_counters",
]

# the reference's comm_ws.COMM_IMPLS; "pallas" names the CUDA kernel path
COMM_IMPLS = ("auto", "dense", "ws", "pallas")
# AdamW's constants in the local step (optimizers.adamw's defaults)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class DistTamunaConfig:
    gamma: float  # local stepsize (AdamW's learning rate under "adamw")
    c: int  # cohort size (2 <= c <= n)
    s: int  # sparsity index (2 <= s <= c); s == c disables compression
    p: float  # inverse expected local steps per round
    eta: Optional[float] = None  # control stepsize; None -> Remark 2 default
    uplink: str = "masked_psum"  # "masked_psum" | "block_rs"
    microbatches: int = 1  # gradient accumulation steps per local step
    local_opt: str = "sgd"  # "sgd" (the paper's rule) | "adamw"
    use_kernel: bool = False  # the reference's fused local-step kernel;
    #   the port's sgd step always takes fused_local_step (kernel on the
    #   card, its plain version on the CPU), so it is only validated here
    comm_impl: str = "auto"  # "auto" | "dense" | "ws" | "pallas"
    wire_precision: str = "f32"  # UpCom payload width: "auto" | "f32" |
    #   "bf16" | "f16" | "int8" | "int4"; "f32" is the unquantized path,
    #   bitwise; "auto" resolves per leaf size
    wire_down: bool = False  # also quantize the DownCom broadcast
    robust_agg: str = "mean"  # per-coordinate combiner: "mean" |
    #   "trimmed" (trim_k per side) | "median"; "mean" (and trimmed at
    #   k=0) is the mean path, bitwise
    trim_k: int = 0  # values trimmed per side under robust_agg="trimmed"

    def __post_init__(self):
        if not (2 <= self.s <= self.c):
            raise ValueError(f"need 2 <= s <= c, got s={self.s} c={self.c}")
        if self.wire_precision not in wire.WIRE_POLICIES:
            raise ValueError(
                f"unknown wire_precision {self.wire_precision!r}; want one "
                f"of {wire.WIRE_POLICIES}")
        if self.wire_down and not wire.is_wire(self.wire_precision):
            raise ValueError(
                "wire_down quantizes the DownCom broadcast; it needs a "
                f"non-f32 wire_precision, got {self.wire_precision!r}")
        if self.uplink not in ("masked_psum", "block_rs"):
            raise ValueError(f"unknown uplink {self.uplink!r}")
        if self.comm_impl not in COMM_IMPLS:
            raise ValueError(
                f"unknown comm_impl {self.comm_impl!r}; want one of "
                f"{COMM_IMPLS}")
        if self.local_opt not in ("sgd", "adamw"):
            raise ValueError(f"unknown local_opt {self.local_opt!r}")
        if self.use_kernel and self.local_opt != "sgd":
            raise ValueError(
                "use_kernel fuses the paper's SGD rule; it does not apply "
                f"to local_opt={self.local_opt!r}")
        if self.microbatches < 1:
            raise ValueError(f"need microbatches >= 1, got "
                             f"{self.microbatches}")
        # validates robust_agg/trim_k against s (raises on bad specs)
        robust.normalize_robust(self.robust_agg, self.trim_k, self.s)

    def robust_(self) -> Optional[Tuple[str, int]]:
        """The normalized robust-combiner spec the comm step takes:
        ``None`` (the mean path) or ``("trimmed", k)``/``("median", 0)``."""
        return robust.normalize_robust(self.robust_agg, self.trim_k, self.s)

    def eta_(self, n: int) -> float:
        """Control-variate stepsize: Remark 2's ``p * chi_max(n, s)`` over
        the population ``n``."""
        if self.eta is not None:
            return self.eta
        return theory.recommended_eta(self.p, max(n, 2), self.s)


@dataclasses.dataclass
class DistTamunaState:
    """Client-stacked state; the workspaces are updated in place."""

    x: torch.Tensor  # (n, d_total) f32: row i is client i's parameters
    h: torch.Tensor  # (n, d_total) f32 control variates; sum_i h_i == 0
    spec: comm_ws.WorkspaceSpec  # leaf layout of a row
    # the local optimizer's state: () for sgd; for adamw an
    # optimizers.AdamState of two (n, d_total) f32 workspaces laid out as
    # x and a step count shared by every client
    opt: Any = ()
    round: int = 0
    # cumulative per-client wire counters, f32 scalars as the reference's
    # (their sums round as the reference's do past 2^24)
    up_floats: np.float32 = np.float32(0)  # uplink floats
    down_floats: np.float32 = np.float32(0)
    up_bytes: np.float32 = np.float32(0)  # uplink wire bytes
    down_bytes: np.float32 = np.float32(0)


def _model_split(mesh: Optional[Mesh2D]) -> bool:
    """Whether ``mesh`` splits the leaves (more than one model rank)."""
    return mesh is not None and mesh.mp > 1


def state_spec(cfg: ModelConfig, tcfg: DistTamunaConfig,
               mesh: Optional[Mesh2D] = None) -> comm_ws.WorkspaceSpec:
    """The workspace layout of ``cfg`` under ``tcfg``: the reference's leaf
    order, but for the cyclic template's tall-and-thin leaves (``D s <
    c``), which go last so that the kernels run over the columns before
    them (``comm_ws.cyclic_comm(tall=)``).  With a ``mesh`` that splits
    the leaves, the row of its model rank: each leaf's block
    (``sharding.local_shape``), in the same order (tall leaves decided on
    the global sizes)."""
    specs = model_api.param_specs(cfg)
    last = ()
    if tcfg.uplink == "masked_psum":
        dims = [int(torch.Size(shape).numel()) for _, shape in specs]
        last = {specs[i][0] for i in comm_ws.tall_leaves(dims, tcfg.c,
                                                         tcfg.s)}
    if _model_split(mesh):
        ps = sharding.params_pspecs(cfg, mesh.mp)
        specs = [(nm, sharding.local_shape(shape, ps[nm], mesh.mp))
                 for nm, shape in specs]
    return comm_ws.workspace_spec(specs, last=last)


def block_coords(cfg: ModelConfig, spec: comm_ws.WorkspaceSpec,
                 mesh: Optional[Mesh2D], device=None
                 ) -> List[Optional[torch.Tensor]]:
    """Each leaf's global coordinates of the mesh's model rank's block
    (``sharding.shard_coords``, int64 on ``device``), in ``spec``'s order;
    ``None`` for a whole leaf (and for every leaf without a splitting
    mesh)."""
    if not _model_split(mesh):
        return [None] * len(spec.names)
    ps = sharding.params_pspecs(cfg, mesh.mp)
    shapes = dict(model_api.param_specs(cfg))
    return [sharding.shard_coords(shapes[nm], ps[nm], mesh.mp, mesh.m_index,
                                  device) for nm in spec.names]


def init_state(cfg: ModelConfig, tcfg: DistTamunaConfig, n: int, *,
               seed: int = 0, device="cuda",
               rows: Optional[RankRows] = None,
               mesh: Optional[Mesh2D] = None) -> DistTamunaState:
    """Every client starts from the same random model (drawn from a
    ``torch.Generator`` seeded with ``seed``); h starts at zero, and so do
    AdamW's moments under ``local_opt="adamw"``.  ``rows`` (a
    ``sharding.RankRows`` of the population ``n``) allocates only a
    rank's rows, bitwise those rows of the whole state.  ``mesh`` (a
    ``sharding.Mesh2D``; its ``rows`` replace ``rows``) also keeps only
    the model rank's blocks of the leaves: the whole model is drawn as
    without it (a temporary, freed before this returns) and each leaf's
    block copied out, so the state is bitwise the blocks of the
    one-process state."""
    if tcfg.c > n:
        raise ValueError(f"cohort c={tcfg.c} exceeds population n={n}")
    if mesh is not None:
        rows = mesh.rows
    if rows is not None and rows.n != n:
        raise ValueError(f"rows cover {rows.n} clients, not n={n}")
    params = model_api.init(cfg, seed=seed, device=device)
    spec = state_spec(cfg, tcfg, mesh)
    if _model_split(mesh):
        ps = sharding.params_pspecs(cfg, mesh.mp)
        params = {nm: v[sharding.block_slices(v.shape, ps[nm], mesh.mp,
                                              mesh.m_index)]
                  for nm, v in params.items()}
    dev = params["embed"].device
    held = n if rows is None else rows.local
    x = torch.empty(held, spec.d_total, dtype=torch.float32, device=dev)
    if held:
        comm_ws.pack(params, spec, x[0])
        x[1:] = x[0]
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the whole model's draw
    h = torch.zeros_like(x)
    opt: Any = ()
    if tcfg.local_opt == "adamw":
        opt = optimizers.AdamState(mu=torch.zeros_like(x),
                                   nu=torch.zeros_like(x), count=0)
    return DistTamunaState(x=x, h=h, spec=spec, opt=opt)


def h_sum_rounding(state: DistTamunaState, tcfg: DistTamunaConfig, n: int,
                   rounds: int, rows: Optional[Sequence[int]] = None
                   ) -> Tuple[float, float, str]:
    """How far sum_i h_i = 0 is off after ``rounds`` fault-free rounds of
    the mean combine from h = 0, against what f32 rounding allows: the
    worst leaf's ``max |sum_i h_i|`` as a share of its bound, the same in
    ulps of the leaf's ``max |x|`` (over ``rows``; every row when
    ``None``), and the leaf's name.  ``s`` must be a power of two.

    A round adds ``scale (x_bar - x_i)`` (``scale = eta / gamma``) to the h
    of each of a coordinate's s owners.  In exact arithmetic these sum to
    ``scale`` times the rounding of x_bar's owner sum (the ``1/s`` is
    exact): s - 1 additions, each off by at most half an ulp of ``s
    max|x|``, so ``scale s (s - 1) / 2`` ulps of ``max|x|``.  Each owner
    rounds its difference, its product and its sum, each by at most half
    an ulp of a term below ``2 max|h|`` while h grows from 0: ``2 s`` ulps
    of ``max|h|``.  Per round, ``rounds`` times.  The bound reads the final
    ``max|x|`` and ``max|h|``.  Column chunks: a population-sized
    workspace needs no copy."""
    s = tcfg.s
    if s & (s - 1):
        raise ValueError(f"the bound takes s a power of two, got s={s}")
    scale = tcfg.eta_(n) / tcfg.gamma
    x = state.x if rows is None else state.x[list(rows)]

    def ulp(v: float) -> float:
        return 2.0 ** (np.floor(np.log2(v)) - 23) if v > 0 else 2.0 ** -149

    worst = (0.0, 0.0, "")
    for name, off, d in zip(state.spec.names, state.spec.offsets,
                            state.spec.dims):
        hs = xm = hm = 0.0
        for a in range(off, off + d, 1 << 25):
            b = min(a + (1 << 25), off + d)
            hs = max(hs, float(state.h[:, a:b].sum(0).abs().max()))
            hm = max(hm, float(state.h[:, a:b].abs().max()))
            xm = max(xm, float(x[:, a:b].abs().max()))
        bound = rounds * (scale * s * (s - 1) / 2 * ulp(xm) + 2 * s * ulp(hm))
        worst = max(worst, (hs / bound, hs / ulp(xm), name))
    return worst


def store_rows(x: torch.Tensor, rows, dtype: torch.dtype) -> None:
    """Round the ``rows`` of the workspace ``x`` (row indices, an ``(n,)``
    bool mask, or None for all of ``x``, a single row's view too) to the
    parameters' storage ``dtype`` in place, nothing for f32: the
    workspace holds bf16 parameters as their f32 values, and the
    reference's round casts each write of x back to the storage dtype
    (``astype(x.dtype)`` after a local step and a fault injection,
    ``comm_ws._downcom`` after the comm step)."""
    if dtype == torch.float32:
        return
    sel = (slice(None) if rows is None
           else torch.as_tensor(rows, device=x.device))
    x[sel] = x[sel].to(dtype).to(x.dtype)


def member_mask(cohort: Sequence[int], n: int) -> torch.Tensor:
    """``(n,)`` bool membership of a cohort (on the CPU)."""
    mask = torch.zeros(n, dtype=torch.bool)
    mask[torch.as_tensor(cohort, dtype=torch.long)] = True
    return mask


@dataclasses.dataclass
class Cohort:
    """The cohort's rows of the state as views: ``x[a]``/``h[a]`` (and
    AdamW's ``mu[a]``/``nu[a]``) alias row ``rows[a]`` of the workspaces;
    ``count`` is AdamW's shared step count (``None`` under sgd), carried
    back by ``scatter_cohort``."""

    rows: List[int]
    x: List[torch.Tensor]
    h: List[torch.Tensor]
    mu: Optional[List[torch.Tensor]] = None
    nu: Optional[List[torch.Tensor]] = None
    count: Optional[int] = None


def gather_cohort(state: DistTamunaState,
                  cohort: Sequence[int]) -> Cohort:
    """The cohort's rows for local training.  The reference gathers them
    into a compact copy; here they are views of the workspace rows, so the
    local steps update the state in place and no copy is made.  AdamW's
    moments come along as views and its count as the shared scalar."""
    rows = [int(i) for i in cohort]
    out = Cohort(rows, [state.x[i] for i in rows],
                 [state.h[i] for i in rows])
    if isinstance(state.opt, optimizers.AdamState):
        out.mu = [state.opt.mu[i] for i in rows]
        out.nu = [state.opt.nu[i] for i in rows]
        out.count = int(state.opt.count)
    return out


def scatter_cohort(state: DistTamunaState,
                   compact: Cohort) -> DistTamunaState:
    """The inverse of ``gather_cohort``: the rows were views, so they are
    already in place (raises if they are not views of this state); AdamW's
    count is taken back from the cohort."""
    pairs = [(compact.x, state.x), (compact.h, state.h)]
    adam = isinstance(state.opt, optimizers.AdamState)
    if adam:
        pairs += [(compact.mu, state.opt.mu), (compact.nu, state.opt.nu)]
    for views, ws in pairs:
        for i, v in zip(compact.rows, views):
            if v.data_ptr() != ws[i].data_ptr():
                raise ValueError(f"cohort row {i} is not a view of the "
                                 "state")
    if adam:
        state.opt = optimizers.AdamState(state.opt.mu, state.opt.nu,
                                         compact.count)
    return state


def _client_grads(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], microbatches: int,
                  tp=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One client's loss and gradients (in ``params``' order) of its batch
    (``tokens``/``labels`` ``(b, T)``, ``prefix_embeds`` ``(b, P, d)``,
    ``frames`` ``(b, n_frames, d)``).
    With ``M = microbatches > 1`` the batch axis splits into M equal parts
    (``b % M != 0`` raises); their losses and gradients are summed in f32
    from zero in microbatch order, then multiplied by the f32 of ``1 / M``
    (the reference's ``_client_grads``).  One accumulator of the client's
    gradients is alive at a time, beside the microbatch's own.  ``tp``:
    ``params`` are a model rank's blocks and the layers tensor parallel
    (``model_api.loss``); the loss is the same on every model rank."""
    leaves = list(params.values())

    def value_and_grad(b):
        loss, _ = model_api.loss(params, cfg, tp=tp, **b)
        return loss, list(torch.autograd.grad(loss, leaves))

    if microbatches == 1:
        loss, grads = value_and_grad(batch)
        return loss.detach(), grads
    M = microbatches
    nb = batch["tokens"].shape[0]
    if nb % M:
        raise ValueError(f"a client's batch of {nb} does not split into "
                         f"{M} microbatches")
    mb = nb // M
    dev = batch["tokens"].device
    tot_l = torch.zeros((), dtype=torch.float32, device=dev)
    tot_g = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
             for x in leaves]
    for j in range(M):
        part = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
        loss, grads = value_and_grad(part)
        tot_l = tot_l + loss.detach()
        for acc, g in zip(tot_g, grads):
            acc.add_(g)
        del grads
    inv = 1.0 / M
    for acc in tot_g:
        acc.mul_(inv)
    return tot_l * inv, tot_g


def make_local_step(cfg: ModelConfig, tcfg: DistTamunaConfig,
                    mesh: Optional[Mesh2D] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``fn(compact, *, tokens, labels, prefix_embeds=None,
    frames=None) -> {"loss": mean loss, "losses": (k,) member losses}``
    (``"loss"`` only when the cohort has a member: a rank may host
    none of it).

    ``tokens``/``labels`` are ``(c, b, T)``, row ``a`` the batch of cohort
    member ``a``, ``prefix_embeds`` ``(c, b, P, d_model)`` where the
    model has a prefix and ``frames`` ``(c, b, n_frames, d_model)`` for
    the encoder-decoder; microbatches split the frames with the tokens.  Each member's loss and gradient are taken on
    views of its workspace row (``tcfg.microbatches`` at a time), then the
    row is updated leaf by leaf: ``fused_local_step`` writes ``x - gamma
    (g - h)`` under sgd; under adamw the gradient becomes ``g - h`` in
    place and ``optimizers.adamw_leaf`` updates x and the moments.
    Members are independent, so one at a time is the reference's vmap over
    them, with one member's gradients alive at once; AdamW's count goes up
    once per call, as the reference's one update of the stacked state.
    With a ``cfg.param_dtype`` other than f32 the loss and gradients are
    taken on the row's leaves cast to it (so the gradients come in that
    dtype, as the reference's of its bf16 leaves), the update runs in f32
    and the row is rounded back to it (``store_rows``).

    ``mesh`` (a ``sharding.Mesh2D`` that splits the leaves): the rows hold
    the model rank's blocks, which the tensor-parallel layers train
    (``sharding.check_model_parallel`` must pass); every model rank of a
    data rank runs the same members in the same order."""
    gamma = tcfg.gamma
    adam = tcfg.local_opt == "adamw"
    spec = state_spec(cfg, tcfg, mesh)
    pd = cfg.param_dtype
    tp = None
    if _model_split(mesh):
        sharding.check_model_parallel(cfg, mesh.mp)
        tp = mesh.tp

    def fn(compact: Cohort, *, tokens: torch.Tensor, labels: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor] = None,
           frames: Optional[torch.Tensor] = None
           ) -> Dict[str, torch.Tensor]:
        if adam:
            count = compact.count + 1
            mu_hat, nu_hat = optimizers.adamw_bias_scales(count, ADAM_B1,
                                                          ADAM_B2)
        losses = []
        for a, (xr, hr) in enumerate(zip(compact.x, compact.h)):
            xs = comm_ws.leaf_views(xr, spec)
            hs = comm_ws.leaf_views(hr, spec)
            params = {k: v.detach().to(pd).requires_grad_(True)
                      for k, v in xs.items()}
            batch = {"tokens": tokens[a], "labels": labels[a]}
            if prefix_embeds is not None:
                batch["prefix_embeds"] = prefix_embeds[a]
            if frames is not None:
                batch["frames"] = frames[a]
            loss, grads = _client_grads(cfg, params, batch,
                                        tcfg.microbatches, tp)
            del params
            if adam:
                ms = comm_ws.leaf_views(compact.mu[a], spec)
                ns = comm_ws.leaf_views(compact.nu[a], spec)
            for (name, xv), g in zip(xs.items(), grads):
                g = g.to(torch.float32).contiguous()
                if adam:
                    g.sub_(hs[name])  # the h-corrected gradient, in f32
                    optimizers.adamw_leaf(
                        xv, g, ms[name], ns[name], lr=gamma, b1=ADAM_B1,
                        b2=ADAM_B2, eps=ADAM_EPS, weight_decay=0.0,
                        mu_hat=mu_hat, nu_hat=nu_hat)
                else:
                    fused_local_step(xv, g, hs[name], gamma, out=xv)
            del grads, g
            store_rows(xr, None, pd)
            losses.append(loss)
        if adam:
            compact.count = count
        if not losses:
            return {"losses": torch.zeros(0, dtype=torch.float32,
                                          device=tokens.device)}
        stacked = torch.stack(losses)
        return {"loss": stacked.mean(), "losses": stacked}

    return fn


def _impl(impl: str) -> str:
    """The comm path an impl runs: ``"kernel"`` (``auto``, ``pallas``) or
    the plain ``"ws"``/``"dense"``."""
    if impl not in COMM_IMPLS:
        raise ValueError(f"unknown comm_impl {impl!r}; want one of "
                         f"{COMM_IMPLS}")
    return "kernel" if impl in ("auto", "pallas") else impl


def make_comm_step(cfg: ModelConfig, tcfg: DistTamunaConfig, n: int,
                   device="cuda", impl: Optional[str] = None,
                   with_stats: bool = False,
                   group: Optional[RankRows] = None,
                   mesh: Optional[Mesh2D] = None):
    """Build ``fn(state, cohort, perm=None, down=None, arrived=None,
    correct=True, wire_seed=None, *, off=None) -> state``: UpCom +
    control-variate update + DownCom of one round, in place.  With
    ``with_stats`` it returns ``(state, {"uncovered": int})``, the
    coordinates no arrived member owns (``comm_ws.uncovered_coords``,
    counted on the host from the slots).

    ``cohort`` is the round's ``c`` clients.  Under ``masked_psum`` ``perm``
    is a permutation of the ``c`` template columns (cohort member ``a``
    uploads column ``perm[a]``); under ``block_rs`` ``off`` is the round's
    shift in ``[0, c)`` (member ``a``, in cohort slot ``a``, owns the
    blocks ``a + off .. a + off + s - 1`` mod c).  ``down`` is the ``(n,)``
    bool DownCom rows (the next round's cohort; ``None`` broadcasts to
    every row).  ``arrived`` (``(n,)`` bool) and ``correct`` are the
    fault-tolerant round's inputs (``comm_ws.cyclic_comm``); the uplink
    counters then count only the arrived members.  ``wire_seed`` is the
    round's uint32 quantization seed (0 when ``None``; unused on the f32
    wire).

    ``impl`` (default ``tcfg.comm_impl``) picks the path: the kernels over
    the workspaces (``auto``, ``pallas``) or the plain ``ws``/``dense``
    over the rows' leaf views, each leaf written back before the next is
    taken.  The band table, the wire's kind groups, the tall leaves and
    the float and byte accounting are built once here; ``fn.wire_kinds``
    holds each leaf's wire kind in the workspace's leaf order.

    ``group`` (a ``sharding.RankRows`` of the population ``n``): the state
    holds a rank's rows, and the kernel path runs ``comm_ws.shard_comm``
    on them with the round's global slots, DownCom rows and arrivals; the
    counters and the stats stay global, the same on every rank.

    ``mesh`` (a ``sharding.Mesh2D``; its ``rows`` are the ``group``): the
    rows hold the model rank's blocks (``state_spec(mesh=)``).  The band
    and the int wire's coordinate and scale-column tables come from the
    blocks' global coordinates (``comm_ws.band_of_blocks``,
    ``wire_plan(coords=)``), built once here; at one data rank the step
    is the one-process kernel step on the blocks, whose only collective
    is the int wire scales' ``MAX`` over the model group, above it the
    shard engine over the data group.  The counters count the whole
    leaves."""
    c, s = tcfg.c, tcfg.s
    if c > n:
        raise ValueError(f"cohort c={c} exceeds population n={n}")
    path = _impl(impl or tcfg.comm_impl)
    if mesh is not None:
        group = mesh.rows
    split = _model_split(mesh)
    if split and path != "kernel":
        raise ValueError(
            f"comm_impl {impl or tcfg.comm_impl!r} over model blocks is "
            "not ported (ROADMAP A9d): model parallelism takes the kernel "
            "path (auto or pallas)")
    # at one data rank the rows are the whole population's
    sharded = group is not None and not (mesh is not None and mesh.dp == 1)
    if group is not None:
        if group.n != n:
            raise ValueError(f"group covers {group.n} clients, not n={n}")
        if path != "kernel":
            raise ValueError(
                f"comm_impl {impl or tcfg.comm_impl!r} over ranks is not "
                "ported (ROADMAP A9d): the plain ws/dense steps are the "
                "one-process oracles; data parallelism takes the kernel "
                "path (auto or pallas)")
    blocked = tcfg.uplink == "block_rs"
    template = "blocked" if blocked else "cyclic"
    scale = tcfg.eta_(n) / tcfg.gamma
    spec = state_spec(cfg, tcfg, mesh)
    gspec = state_spec(cfg, tcfg)  # the whole leaves
    policy = tcfg.wire_precision
    rspec = tcfg.robust_()
    kinds = tuple(wire.resolve_kind(D, policy) for D in gspec.dims)
    totals = comm_counters(gspec.dims, c, s, kinds, tcfg.wire_down,
                           template=template)
    band = plan = None
    tall: Tuple[Tuple[int, int, int, str], ...] = ()
    if path == "kernel":
        dev = resolve_device(device)
        main = spec.main_leaves
        mdims = spec.dims[:main]
        if split:
            coords = block_coords(cfg, spec, mesh, dev)
            if any(k is not None for k in coords[main:]):
                raise ValueError("a tall-and-thin leaf split over the model "
                                 "axis is not ported")
            band = comm_ws.band_of_blocks(mdims, gspec.dims[:main],
                                          coords[:main], template, c, s,
                                          dev)
            plan = comm_ws.wire_plan(
                mdims, policy, c, s, band, template=template,
                ids=spec.ids[:main], gdims=gspec.dims[:main],
                coords=coords[:main], model=mesh.tp)
        else:
            band = (comm_ws.block_band(mdims, c, dev) if blocked
                    else comm_ws.cyclic_band(mdims, c, s, dev))
            plan = comm_ws.wire_plan(mdims, policy, c, s, band,
                                     template=template, ids=spec.ids[:main])
        tall = tuple((spec.ids[i], spec.offsets[i], spec.dims[i], kinds[i])
                     for i in range(main, len(spec.dims)))
    # the leaves in the reference's order, for the plain paths
    ref_order = sorted(range(len(spec.dims)), key=lambda i: spec.ids[i])

    def fn(state: DistTamunaState, cohort: Sequence[int],
           perm: Optional[Sequence[int]] = None,
           down: Optional[torch.Tensor] = None,
           arrived: Optional[np.ndarray] = None, correct: bool = True,
           wire_seed: Optional[int] = None, *,
           off: Optional[int] = None) -> DistTamunaState:
        cohort = np.asarray(cohort, dtype=np.int64)
        if cohort.shape != (c,):
            raise ValueError(f"need a cohort of {c} clients")
        if blocked:
            if perm is not None or off is None or not 0 <= int(off) < c:
                raise ValueError(f"uplink='block_rs' takes a shift off in "
                                 f"[0, {c}) and no permutation")
            # the client's cohort slot, -1 when idle
            slot = np.full(n, -1, dtype=np.int32)
            slot[cohort] = np.arange(c, dtype=np.int32)
        else:
            perm = np.asarray(perm, dtype=np.int64)
            if off is not None or sorted(perm.tolist()) != list(range(c)):
                raise ValueError(f"uplink='masked_psum' takes a "
                                 f"permutation of range({c}) and no shift")
            # the client's template column: perm[cohort slot], -1 when idle
            slot = np.full(n, -1, dtype=np.int32)
            slot[cohort] = perm
        dev = state.x.device
        slot_t = upload(slot, dev)
        arr_t, survivors = None, None
        if arrived is not None:
            arrived = np.asarray(arrived, bool)
            arr_t = upload(arrived, dev)
            survivors = int(arrived[cohort].sum())
        seed = 0 if wire_seed is None else wire_seed
        if path == "kernel":
            down_t = (None if down is None
                      else upload(torch.as_tensor(down).to(torch.int32), dev))
            kw = dict(down=down_t, arrived=arr_t, correct=correct,
                      robust=rspec, wire=plan, wire_seed=seed,
                      wire_down=tcfg.wire_down)
            if sharded:
                kslot = (comm_ws.blocked_slot(slot_t, int(off), c)
                         if blocked else slot_t)
                comm_ws.shard_comm(state.x, state.h, kslot, band, c, s,
                                   scale, group=group, tall=tall, **kw)
            elif blocked:
                comm_ws.blocked_comm(state.x, state.h, int(off), slot_t,
                                     band, c, s, scale, **kw)
            else:
                comm_ws.cyclic_comm(state.x, state.h, slot_t, band, c, s,
                                    scale, tall=tall, **kw)
        else:
            if blocked:
                slot_t = comm_ws.blocked_slot(slot_t, int(off), c)
            xv = comm_ws.unpack(state.x, spec)
            hv = comm_ws.unpack(state.h, spec)
            names = [spec.names[i] for i in ref_order]
            down_b = (None if down is None
                      else torch.as_tensor(down).to(torch.bool))
            for name, xn, hn in comm_ws.iter_comm_leaves(
                    template, [(k, xv[k]) for k in names],
                    [(k, hv[k]) for k in names], slot_t, c, s, scale, path,
                    down=down_b, arrived=arr_t, correct=correct,
                    wire=policy, wire_seed=seed, wire_down=tcfg.wire_down,
                    robust=rspec):
                xv[name].copy_(xn)
                hv[name].copy_(hn)
                del xn, hn
        # the DownCom wrote x_bar to the down rows
        store_rows(state.x, None if down is None
                   else torch.as_tensor(down).to(torch.bool)[
                       sharding.local_rows(group, n)],
                   cfg.param_dtype)
        state.round += 1
        add_counters(state, totals, c, survivors)
        if not with_stats:
            return state
        # the slot each client aggregates with: the template column, or
        # the folded blocked slot; -1 idle or not arrived
        sslot = (np.where(slot >= 0, (-(slot + int(off))) % c, -1)
                 if blocked else slot)
        if arrived is not None:
            sslot = np.where(arrived, sslot, -1)
        return state, {"uncovered": comm_ws.uncovered_coords(
            template, gspec.dims, c, s, sslot)}

    fn.wire_kinds = kinds
    return fn


class CommTotals(NamedTuple):
    """One round's per-client wire counts, f32 as the reference builds
    them (``jnp.float32`` of the exact sums)."""

    up_floats: np.float32
    down_floats: np.float32
    up_bytes: np.float32
    down_bytes: np.float32


def comm_counters(dims: Sequence[int], c: int, s: int,
                  kinds: Sequence[str], wire_down: bool,
                  template: str = "cyclic") -> CommTotals:
    """The per-round totals of a comm step over leaves of sizes ``dims``
    with wire kinds ``kinds``: the cohort template's owned columns per
    client (uplink floats: ``masks.column_nnz`` for the cyclic template,
    ``masks.block_column_nnz`` for the blocked one), every coordinate
    (downlink floats), and their wire bytes (``leaf_up_bytes`` at c=1: one
    client's codes and, for the int kinds, its own chunk scales; the f32
    wire is floats * 4 exactly)."""
    nnz_of = (masks.block_column_nnz if template == "blocked"
              else masks.column_nnz)
    nnzs = [nnz_of(D, c, s) for D in dims]
    return CommTotals(
        np.float32(sum(nnzs)), np.float32(sum(dims)),
        np.float32(sum(wire.leaf_up_bytes(nnz, D, 1, k)
                       for nnz, D, k in zip(nnzs, dims, kinds))),
        np.float32(sum(wire.leaf_down_bytes(D, k if wire_down else "f32")
                       for D, k in zip(dims, kinds))))


def add_counters(state, totals: CommTotals, c: int,
                 survivors: Optional[int] = None) -> None:
    """Add one round's totals to ``state``'s four f32 counters, in f32 and
    in the reference's order.  ``survivors`` (the arrived cohort members of
    a faulted round; ``None`` when all arrived) scales the uplink by the
    arrived fraction ``np.float32(survivors) / np.float32(c)``, an f32
    division as the reference's ``up_arrived``: the template spreads the
    uplink evenly over the c members, and a dropped client ships neither
    codes nor scales."""
    up, upb = totals.up_floats, totals.up_bytes
    if survivors is not None:
        frac = np.float32(survivors) / np.float32(c)
        up, upb = up * frac, upb * frac
    state.up_floats = np.float32(state.up_floats) + up
    state.down_floats = np.float32(state.down_floats) + totals.down_floats
    state.up_bytes = np.float32(state.up_bytes) + upb
    state.down_bytes = np.float32(state.down_bytes) + totals.down_bytes


def sample_round_length(rng: np.random.Generator, p: float,
                        max_L: int = 100_000) -> int:
    """Host-side ``L ~ Geometric(p)`` draw, capped at ``max_L``."""
    return int(min(rng.geometric(p), max_L))
