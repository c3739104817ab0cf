"""TAMUNA-DP on one GPU (``repro.dist.tamuna_dp``): config, state, the
local step, the comm step and the round length.

A round gathers the cohort, runs L local steps ``x <- x - gamma (g - h)``
on the cohort's rows, then one compressed comm step: the owner-masked UpCom
with the exact ``1/s`` rebuild, the control-variate update on owned
coordinates and the DownCom to the ``down`` rows.

Randomness is injected: the comm step takes the round's ``cohort``, the
template permutation ``perm``, the DownCom rows ``down`` and the wire seed
as arguments (the reference draws them from threefry keys);
``dist/rounds.py`` draws the permutation from a ``torch.Generator``, the
cohorts from a numpy stream or a ``CohortPlan`` and the wire seed from a
numpy stream.  The geometric round length is the reference's numpy draw
and ports bitwise.

Only ``uplink="masked_psum"`` with ``local_opt="sgd"`` is ported, with the
mean, trimmed-mean and median combiners (``robust_agg``) and the quantized
wire (``wire_precision``, ``wire_down``).
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import masks, theory
from repro_torch.dist import comm_ws, model_api, robust, wire
from repro_torch.kernels.local_step import fused_local_step
from repro_torch.models.transformer import ModelConfig

__all__ = [
    "DistTamunaConfig",
    "DistTamunaState",
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


@dataclasses.dataclass(frozen=True)
class DistTamunaConfig:
    gamma: float  # local stepsize
    c: int  # cohort size (2 <= c <= n)
    s: int  # sparsity index (2 <= s <= c); s == c disables compression
    p: float  # inverse expected local steps per round
    eta: Optional[float] = None  # control stepsize; None -> Remark 2 default
    uplink: str = "masked_psum"
    local_opt: str = "sgd"
    robust_agg: str = "mean"  # per-coordinate combiner: "mean" |
    #   "trimmed" (trim_k per side) | "median"; "mean" (and trimmed at
    #   k=0) is the mean path, bitwise
    trim_k: int = 0  # values trimmed per side under robust_agg="trimmed"
    wire_precision: str = "f32"  # UpCom payload width: "auto" | "f32" |
    #   "bf16" | "f16" | "int8" | "int4"; "f32" is the unquantized path,
    #   bitwise; "auto" resolves per leaf size
    wire_down: bool = False  # also quantize the DownCom broadcast

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
        if self.uplink != "masked_psum":
            raise ValueError(f"uplink {self.uplink!r} is not ported; only "
                             "'masked_psum' is")
        if self.local_opt != "sgd":
            raise ValueError(f"local_opt {self.local_opt!r} is not ported; "
                             "only 'sgd' is")
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
    round: int = 0
    # cumulative per-client wire counters, f32 scalars as the reference's
    # (their sums round as the reference's do past 2^24)
    up_floats: np.float32 = np.float32(0)  # uplink floats
    down_floats: np.float32 = np.float32(0)
    up_bytes: np.float32 = np.float32(0)  # uplink wire bytes
    down_bytes: np.float32 = np.float32(0)


def init_state(cfg: ModelConfig, tcfg: DistTamunaConfig, n: int, *,
               seed: int = 0, device="cuda") -> DistTamunaState:
    """Every client starts from the same random model (drawn from a
    ``torch.Generator`` seeded with ``seed``); h starts at zero."""
    if tcfg.c > n:
        raise ValueError(f"cohort c={tcfg.c} exceeds population n={n}")
    params = model_api.init(cfg, seed=seed, device=device)
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    dev = params["embed"].device
    x = torch.empty(n, spec.d_total, dtype=torch.float32, device=dev)
    comm_ws.pack(params, spec, x[0])
    del params
    x[1:] = x[0]
    h = torch.zeros_like(x)
    return DistTamunaState(x=x, h=h, spec=spec)


def member_mask(cohort: Sequence[int], n: int) -> torch.Tensor:
    """``(n,)`` bool membership of a cohort (on the CPU)."""
    mask = torch.zeros(n, dtype=torch.bool)
    mask[torch.as_tensor(cohort, dtype=torch.long)] = True
    return mask


class Cohort(NamedTuple):
    """The cohort's rows of the state as views: ``x[a]``/``h[a]`` alias row
    ``rows[a]`` of the workspaces."""

    rows: List[int]
    x: List[torch.Tensor]
    h: List[torch.Tensor]


def gather_cohort(state: DistTamunaState,
                  cohort: Sequence[int]) -> Cohort:
    """The cohort's rows for local training.  The reference gathers them
    into a compact copy; here they are views of the workspace rows, so the
    local steps update the state in place and no copy is made."""
    rows = [int(i) for i in cohort]
    return Cohort(rows, [state.x[i] for i in rows],
                  [state.h[i] for i in rows])


def scatter_cohort(state: DistTamunaState,
                   compact: Cohort) -> DistTamunaState:
    """The inverse of ``gather_cohort``: the rows were views, so they are
    already in place; raises if they are not views of this state."""
    for i, xr, hr in zip(compact.rows, compact.x, compact.h):
        if (xr.data_ptr() != state.x[i].data_ptr()
                or hr.data_ptr() != state.h[i].data_ptr()):
            raise ValueError(f"cohort row {i} is not a view of the state")
    return state


def make_local_step(cfg: ModelConfig, tcfg: DistTamunaConfig
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``fn(compact, *, tokens, labels) -> {"loss": mean loss}``.

    ``tokens``/``labels`` are ``(c, b, T)``, row ``a`` the batch of cohort
    member ``a``.  Each member's loss and gradient are taken on views of its
    workspace row, then ``fused_local_step`` writes ``x - gamma (g - h)``
    into the row leaf by leaf.  Members are independent, so one at a time
    is the reference's vmap over them, with one member's gradients alive
    at once."""
    gamma = tcfg.gamma
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))

    def fn(compact: Cohort, *, tokens: torch.Tensor,
           labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        losses = []
        for a, (xr, hr) in enumerate(zip(compact.x, compact.h)):
            xs = comm_ws.leaf_views(xr, spec)
            hs = comm_ws.leaf_views(hr, spec)
            params = {k: v.detach().requires_grad_(True)
                      for k, v in xs.items()}
            loss, _ = model_api.loss(params, cfg, tokens=tokens[a],
                                     labels=labels[a])
            grads = torch.autograd.grad(loss, list(params.values()))
            for (name, xv), g in zip(xs.items(), grads):
                fused_local_step(xv, g.contiguous(), hs[name], gamma, out=xv)
            losses.append(loss.detach())
        return {"loss": torch.stack(losses).mean()}

    return fn


def make_comm_step(cfg: ModelConfig, tcfg: DistTamunaConfig, n: int,
                   device="cuda"):
    """Build ``fn(state, cohort, perm, down=None, arrived=None,
    correct=True, wire_seed=None) -> state``: UpCom + control-variate
    update + DownCom of one round, in place.

    ``cohort`` is the round's ``c`` clients, ``perm`` a permutation of the
    ``c`` template columns (cohort member ``a`` uploads column
    ``perm[a]``), ``down`` the ``(n,)`` bool DownCom rows (the next
    round's cohort; ``None`` broadcasts to every row).  ``arrived``
    (``(n,)`` bool) and ``correct`` are the fault-tolerant round's inputs
    (``comm_ws.cyclic_comm``); the uplink counters then count only the
    arrived members.  ``wire_seed`` is the round's uint32 quantization
    seed (0 when ``None``; unused on the f32 wire).  The band table, the
    wire's kind groups and the float and byte accounting are built once
    here; ``fn.wire_kinds`` holds each leaf's wire kind."""
    c, s = tcfg.c, tcfg.s
    if c > n:
        raise ValueError(f"cohort c={c} exceeds population n={n}")
    scale = tcfg.eta_(n) / tcfg.gamma
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    tall = [nm for nm, D in zip(spec.names, spec.dims) if D * s < c]
    if tall:
        raise NotImplementedError(
            f"leaves {tall} are tall-and-thin (D s < c); their dense "
            "fallback is not ported")
    band = comm_ws.cyclic_band(spec.dims, c, s, resolve_device(device))
    rspec = tcfg.robust_()
    plan = comm_ws.wire_plan(spec.dims, tcfg.wire_precision, c, s, band)
    kinds = tuple(wire.resolve_kind(D, tcfg.wire_precision)
                  for D in spec.dims)
    totals = comm_counters(spec.dims, c, s, kinds, tcfg.wire_down)

    def fn(state: DistTamunaState, cohort: Sequence[int],
           perm: Sequence[int], down: Optional[torch.Tensor] = None,
           arrived: Optional[np.ndarray] = None, correct: bool = True,
           wire_seed: Optional[int] = None) -> DistTamunaState:
        cohort = np.asarray(cohort, dtype=np.int64)
        perm = np.asarray(perm, dtype=np.int64)
        if cohort.shape != (c,) or sorted(perm.tolist()) != list(range(c)):
            raise ValueError(f"need a cohort of {c} clients and a "
                             f"permutation of range({c})")
        # the client's template column: perm[cohort slot], -1 when idle
        slot = np.full(n, -1, dtype=np.int32)
        slot[cohort] = perm
        dev = state.x.device
        slot_t = torch.from_numpy(slot).to(dev)
        down_t = (None if down is None
                  else torch.as_tensor(down).to(torch.int32).to(dev))
        arr_t, survivors = None, None
        if arrived is not None:
            arrived = np.asarray(arrived, bool)
            arr_t = torch.from_numpy(arrived).to(dev)
            survivors = int(arrived[cohort].sum())
        comm_ws.cyclic_comm(state.x, state.h, slot_t, band, c, s, scale,
                            down=down_t, arrived=arr_t, correct=correct,
                            robust=rspec, wire=plan,
                            wire_seed=0 if wire_seed is None else wire_seed,
                            wire_down=tcfg.wire_down)
        state.round += 1
        add_counters(state, totals, c, survivors)
        return state

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
                  kinds: Sequence[str], wire_down: bool) -> CommTotals:
    """The per-round totals of a comm step over leaves of sizes ``dims``
    with wire kinds ``kinds``: the cohort template's owned columns per
    client (uplink floats), every coordinate (downlink floats), and their
    wire bytes (``leaf_up_bytes`` at c=1: one client's codes and, for the
    int kinds, its own chunk scales; the f32 wire is floats * 4 exactly)."""
    nnzs = [masks.column_nnz(D, c, s) for D in dims]
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
