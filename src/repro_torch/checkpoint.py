"""Checkpoints in the reference's format (``repro.checkpoint``), with numpy,
json and torch only.

A checkpoint is a directory with ``arrays.npz`` (``leaf_<i>`` in leaf
order; bf16 stored as its raw uint16 bits) and ``meta.json`` (``names``,
``treedef``, ``step``, ``dtypes``, ``shapes``).  Trees are nested dicts
(sorted keys), lists and tuples (by index) and NamedTuples (by field,
named ``.field``), with tensors, numpy arrays and scalars as leaves: the
names ``jax.tree_util.tree_flatten_with_path`` gives the same structure,
so the reference's ``checkpoint.restore`` reads what ``save`` writes here
and ``restore`` reads the reference's.

``save_state``/``restore_state`` take a ``tamuna_dp.DistTamunaState``
through ``state_tree``: the workspaces unpacked per leaf, in the
reference's ``DistTamunaState`` layout (``.x/<leaf>``, ``.h/<leaf>``,
AdamW's ``.opt/.mu/<leaf>``, ``.opt/.nu/<leaf>`` and ``.opt/.count``,
then ``.round`` and the four f32 counters), so a reference checkpoint of
the same model and options restores into the port's state and the
reverse.  bf16 leaves of a reference checkpoint widen to the f32
workspace exactly.

Saves are atomic: the payload is written into a staging directory beside
the target (``.tmp_<name>``) and moved into place with ``os.replace``; an
old checkpoint of that name is removed only once the new one is staged.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "load_named", "state_tree",
           "save_state", "restore_state", "fill_state", "fill_rows"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_names(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` in the reference's leaf order and naming."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_names(tree[k], prefix + (str(k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += _flatten_with_names(getattr(tree, f), prefix + (f".{f}",))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_names(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves: List[Any]):
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*[build(getattr(t, f)) for f in t._fields])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """A leaf as the array to store and its dtype name (bf16 as uint16
    bits, named ``bfloat16``)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return (t.contiguous().view(torch.int16).cpu().numpy()
                    .view(np.uint16), "bfloat16")
        a = t.contiguous().cpu().numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def save(path: str, tree, step: Optional[int] = None) -> None:
    """Write ``tree`` to the checkpoint directory ``path`` atomically."""
    path = os.path.normpath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    # stage under a dot-prefixed sibling: the same file system (so the
    # final os.replace is atomic) and invisible to latest_step's scan
    stage = os.path.join(parent, f".tmp_{os.path.basename(path)}")
    if os.path.isdir(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    try:
        flat = _flatten_with_names(tree)
        arrays, dtypes, shapes = {}, [], []
        for i, (_, leaf) in enumerate(flat):
            a, dt = _to_numpy(leaf)
            arrays[f"leaf_{i}"] = a
            dtypes.append(dt)
            shapes.append(list(a.shape))
        np.savez(os.path.join(stage, "arrays.npz"), **arrays)
        meta = {
            "names": [name for name, _ in flat],
            "treedef": f"port tree of {len(flat)} leaves: "
                       f"{type(tree).__name__}",
            "step": step,
            "dtypes": dtypes,
            "shapes": shapes,
        }
        with open(os.path.join(stage, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(path):
            # os.replace cannot replace a non-empty directory: drop the
            # old checkpoint only now that the new one is staged
            shutil.rmtree(path)
        os.replace(stage, path)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise


def _load_meta(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _from_numpy(arr: np.ndarray, saved_dtype: Optional[str], like):
    """A stored array as a leaf like ``like``: a tensor of its type and
    device (bf16 bits widen exactly or stay bf16), else a numpy value of
    its type."""
    bf16 = saved_dtype == "bfloat16" and arr.dtype == np.uint16
    if isinstance(like, torch.Tensor):
        if bf16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if bf16:
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    ref = np.asarray(like)
    out = arr.astype(ref.dtype)
    return out[()] if out.ndim == 0 and not isinstance(like,
                                                       np.ndarray) else out


def _read(path: str, like) -> List[Tuple[str, np.ndarray, Optional[str],
                                         Any]]:
    """``[(name, stored array, stored dtype name, like's leaf)]`` of the
    checkpoint at ``path`` against the structure of ``like``, after the
    leaf-count and shape checks."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(z.files))]
    flat = _flatten_with_names(like)
    names = [name for name, _ in flat]
    meta = _load_meta(path)
    if len(arrays) != len(flat):
        saved = list(meta["names"]) if meta and "names" in meta else None
        msg = (f"checkpoint has {len(arrays)} leaves, expected "
               f"{len(flat)}")
        if saved is not None:
            missing = sorted(set(saved) - set(names))
            extra = sorted(set(names) - set(saved))
            if missing:
                msg += f"; in checkpoint but not in target: {missing}"
            if extra:
                msg += f"; in target but not in checkpoint: {extra}"
        raise ValueError(msg)
    dtypes = (meta or {}).get("dtypes") or [None] * len(arrays)
    out = []
    for arr, dt, (name, ref) in zip(arrays, dtypes, flat):
        shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at leaf {name!r}: "
                             f"{tuple(arr.shape)} vs {shape}")
        out.append((name, arr, dt, ref))
    return out


def restore(path: str, like):
    """Restore into the structure of ``like`` (the leaf order must match
    the saved one): tensors of ``like``'s types and devices, numpy values
    elsewhere.  A leaf-count mismatch names the leaf paths on both
    sides."""
    return _unflatten(like, [_from_numpy(arr, dt, ref)
                             for _, arr, dt, ref in _read(path, like)])


def load_named(path: str) -> Dict[str, Tuple[np.ndarray, Optional[str]]]:
    """Every leaf of the checkpoint at ``path`` by its name: ``{name:
    (stored array, stored dtype name)}``."""
    meta = _load_meta(path)
    if meta is None or "names" not in meta:
        raise ValueError(f"no checkpoint meta.json with leaf names at "
                         f"{path!r}")
    dtypes = meta.get("dtypes") or [None] * len(meta["names"])
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {name: (z[f"leaf_{i}"], dt)
                for i, (name, dt) in enumerate(zip(meta["names"], dtypes))}


def latest_step(root: str) -> Optional[int]:
    """The largest ``k`` of the ``step_<k>`` directories under ``root``."""
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("step_")]
    return max(steps) if steps else None


# --------------------------------------------------------------------------
# the TAMUNA-DP state
# --------------------------------------------------------------------------


class StateTree(NamedTuple):
    """The reference's ``DistTamunaState`` fields, in its order."""

    x: Any
    h: Any
    opt: Any
    round: Any
    up_floats: Any
    down_floats: Any
    up_bytes: Any
    down_bytes: Any


def _nest(flat: dict) -> dict:
    """``{"a/b": v}`` -> ``{"a": {"b": v}}``."""
    out: dict = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def state_tree(state) -> StateTree:
    """``state`` (a ``tamuna_dp.DistTamunaState``) as the reference's
    ``DistTamunaState`` tree: the workspaces as ``(n, *shape)`` leaf views
    (no copy), AdamW's state as an ``optimizers.AdamState`` with an int32
    count (``()`` under sgd), the round as int32 and the counters as f32
    scalars."""
    from repro_torch.dist import comm_ws
    from repro_torch.optim import optimizers

    spec = state.spec
    opt: Any = ()
    if isinstance(state.opt, optimizers.AdamState):
        opt = optimizers.AdamState(
            mu=_nest(comm_ws.unpack(state.opt.mu, spec)),
            nu=_nest(comm_ws.unpack(state.opt.nu, spec)),
            count=np.int32(state.opt.count))
    return StateTree(
        x=_nest(comm_ws.unpack(state.x, spec)),
        h=_nest(comm_ws.unpack(state.h, spec)), opt=opt,
        round=np.int32(state.round),
        up_floats=np.float32(state.up_floats),
        down_floats=np.float32(state.down_floats),
        up_bytes=np.float32(state.up_bytes),
        down_bytes=np.float32(state.down_bytes))


def save_state(path: str, state, step: Optional[int] = None) -> None:
    """``save`` of ``state_tree(state)``: one leaf at a time leaves the
    card."""
    save(path, state_tree(state), step)


def restore_state(path: str, state):
    """Restore a checkpoint of the reference's ``DistTamunaState`` layout
    into ``state`` in place (its workspaces leaf by leaf, AdamW's moments
    and count, the round and the counters); returns ``state``.  Leaf
    names, count and shapes must be those ``state_tree(state)`` gives."""
    return _fill(state, [(arr, dt, ref) for _, arr, dt, ref
                         in _read(path, state_tree(state))])


def fill_state(state, named: Dict[str, Tuple[np.ndarray, Optional[str]]],
               prefix: str = ""):
    """``restore_state`` from ``load_named``'s leaves whose names are
    ``state_tree(state)``'s under ``prefix``; other leaves are ignored."""
    items = []
    for name, ref in _flatten_with_names(state_tree(state)):
        key = prefix + name
        if key not in named:
            raise ValueError(f"checkpoint has no leaf {key!r}")
        arr, dt = named[key]
        shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at leaf {key!r}: "
                             f"{tuple(arr.shape)} vs {shape}")
        items.append((arr, dt, ref))
    return _fill(state, items)


def fill_rows(state, named: Dict[str, Tuple[np.ndarray, Optional[str]]],
              rows: Sequence[int], prefix: str) -> Optional[int]:
    """Write a compact state of ``len(rows)`` clients (the reference's
    ``gather_cohort`` tree: ``.x/<leaf>``, ``.h/<leaf>`` and AdamW's
    ``.opt/.mu/<leaf>``, ``.opt/.nu/<leaf>`` of shape ``(len(rows),
    *leaf)``, under ``prefix``) into the workspace rows ``rows`` of
    ``state``.  Returns the compact AdamW count, or None under sgd."""
    from repro_torch.optim import optimizers

    spec = state.spec
    wss = [(".x/", state.x), (".h/", state.h)]
    adam = isinstance(state.opt, optimizers.AdamState)
    if adam:
        wss += [(".opt/.mu/", state.opt.mu), (".opt/.nu/", state.opt.nu)]
    f32 = torch.empty((), dtype=torch.float32)
    for tag, ws in wss:
        for name, shape, D, o in zip(spec.names, spec.shapes, spec.dims,
                                     spec.offsets):
            key = prefix + tag + name
            arr, dt = named[key]
            if tuple(arr.shape) != (len(rows),) + tuple(shape):
                raise ValueError(f"shape mismatch at leaf {key!r}: "
                                 f"{tuple(arr.shape)}")
            vals = _from_numpy(arr, dt, f32).reshape(len(rows), D)
            for a, i in enumerate(rows):
                ws[int(i), o:o + D].copy_(vals[a])
    if not adam:
        return None
    return int(named[prefix + ".opt/.count"][0])


def _fill(state, items):
    """Copy ``[(stored array, dtype name, leaf of state_tree(state))]`` into
    ``state``: the workspace leaves in place, then the scalars."""
    from repro_torch.optim import optimizers

    leaves = []
    for arr, dt, ref in items:
        if isinstance(ref, torch.Tensor):
            ref.copy_(_from_numpy(arr, dt, torch.empty(
                (), dtype=ref.dtype)).view(ref.shape))
        else:
            leaves.append(_from_numpy(arr, dt, ref))
    # the scalars, in StateTree's order (the count first under adamw)
    if isinstance(state.opt, optimizers.AdamState):
        count, *leaves = leaves
        state.opt = optimizers.AdamState(state.opt.mu, state.opt.nu,
                                         int(count))
    rnd, up, down, upb, downb = leaves
    state.round = int(rnd)
    state.up_floats, state.down_floats = np.float32(up), np.float32(down)
    state.up_bytes, state.down_bytes = np.float32(upb), np.float32(downb)
    return state
