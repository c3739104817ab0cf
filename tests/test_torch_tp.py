"""The model axis (ROADMAP A9b) against the reference: the parameter rules,
the blocks' coordinates and bands, the comm step on model-sharded blocks,
and the tensor-parallel dense layers.

* **Rules.** ``sharding.params_pspecs`` equals the reference's
  ``sharding.params_pspecs`` (on ``jax.eval_shape`` of its ``init``,
  nothing allocated) for all ten configs at model sizes 2, 4 and 16, with
  and without ``moe_expert_parallel``; ``check_model_parallel`` takes the
  dense configs whose heads split whole and refuses the rest naming A9c.
* **Coordinates and bands.** ``sharding.shard_coords`` equals the
  reference's ``comm_ws._shard_coords`` inside ``shard_map`` on ``(1, 2)``
  and ``(2, 2)`` host meshes for leaves split on their first, a middle and
  their last dim, and ``comm_ws.cyclic_band_at``/``block_band_at`` of them
  equal the reference's whole-leaf band tables at those coordinates.
* **The comm step.** The reference's meshed ``cyclic_comm``/
  ``blocked_comm`` (``impl="pallas", meshed=True, shard_kernels=False``)
  with model-parallel ``pspecs`` (the entry ``tests/test_comm_shard.py``
  drives) on ``(1, 2)`` and ``(2, 2)``, against the port on 2 and 4 gloo
  ranks: the one-process kernel step on each block at one data rank, the
  shard engine above (``tamuna_dp.make_comm_step(mesh=)``'s choice).
  Variants: the mean, the survivor rebuild (one member dropped), the int8
  wire with ``wire_down``, trimmed k = 1 (the median at s = 2), each on
  both meshes, at ``(n, c, s) = (4, 3, 2)`` on one and ``(5, 4, 3)`` on the
  other (5 rows do not split evenly over 2 data ranks).  The leaves' chunks
  of 256 straddle the two model blocks, so ``wire.leaf_scales_at``'s
  ``MAX`` decides the scales.  Tolerances as ``tests/test_torch_shard.py``:
  x bitwise at s = 2 but on the int wire, else 1e-6 (one DownCom level
  under ``wire_down`` at s >= 3).  Every model rank's scale ``MAX`` has
  the leaves' global chunk count: one per kind group and step.
* **Layers.** The reduced gemma2-2b at mp = 2 (``model_api.loss(tp=)``):
  its loss and its gathered gradients against the port's one-process
  loss and gradients (held to the reference in ``test_torch_model.py``).
  The row-parallel products and the vocab-parallel logsumexp split their
  sums, so they are not bitwise; the bound is derived from a float64
  evaluation of the same model: per leaf, the distance to the one
  process is at most ``TP_FACTOR`` times the one process's own distance
  to float64, plus ``TP_FLOOR`` of the leaf's largest gradient.  The
  norm scales' gradients, replicated, come out equal on both model
  ranks.

The reference's outputs come from one subprocess (16 forced host
devices, one npz); the port's run in one ``sharding.spawn`` of 4 ranks
(one intra-op thread each, a ``file://`` store under the test's
temporary directory), whose first pair of model ranks also stands alone
as the ``(1, 2)`` mesh (each with a one-rank data group).
"""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist import comm_ws, model_api, sharding

ARCHS = tuple(registry.list_archs())
MSIZES = (2, 4, 16)
# leaf: (global shape, the dim split over the model axis, or None)
LEAVES = (("a", (6, 100), 0), ("b", (3, 4, 50), 1), ("c", (5, 64), 1),
          ("d", (29,), None))
CASES = [(4, 3, 2), (5, 4, 3)]
SCALE = 0.37
TOL = 1e-6
WSEED = 0xC0FFEE
# name: (template, a member dropped, robust kind, wire policy, wire_down)
VARIANTS = {
    "cyc": ("cyclic", False, None, None, False),
    "blk_surv": ("blocked", True, None, None, False),
    "cyc_int8_down": ("cyclic", False, None, "int8", True),
    "cyc_trim": ("cyclic", False, "trimmed", None, False),
}
MESHES = ((1, 2), (2, 2))
# the (case, variant) items each mesh runs: every variant on both meshes,
# each at s = 2 on one and s = 3 on the other
ITEMS = {(1, 2): (((4, 3, 2), "cyc"), ((5, 4, 3), "blk_surv"),
                  ((4, 3, 2), "cyc_int8_down"), ((5, 4, 3), "cyc_trim")),
         (2, 2): (((5, 4, 3), "cyc"), ((4, 3, 2), "blk_surv"),
                  ((5, 4, 3), "cyc_int8_down"), ((4, 3, 2), "cyc_trim"))}
# the layers' bound: TP_FACTOR x the one process's distance to float64
# plus TP_FLOOR of the leaf's largest |gradient|.  Both f32 evaluations
# are within their own rounding of the float64 one, so their distance is
# at most about twice either's (the triangle inequality); measured on
# these inputs, the tensor-parallel leaves lie 0.39-0.80 times the one
# process's distance from it, and the losses agree exactly.  The floor
# covers a leaf whose f32 gradient happens to be near exact.
TP_FACTOR = 2.0
TP_FLOOR = 2.0 ** -22
LAYER_SEQ = 16


def _key(case):
    return "_".join(map(str, case))


def _inputs(n, c, s):
    """A case's leaves, slots and masks from a numpy stream."""
    rng = np.random.default_rng(2000 * n + 10 * c + s)
    x = {k: rng.normal(size=(n,) + shape).astype(np.float32)
         for k, shape, _ in LEAVES}
    h = {k: rng.normal(size=(n,) + shape).astype(np.float32)
         for k, shape, _ in LEAVES}
    cohort = np.sort(rng.choice(n, size=c, replace=False))
    slot = np.full(n, -1, np.int32)
    slot[cohort] = rng.permutation(c)
    slot_of = np.full(n, -1, np.int32)
    slot_of[cohort] = np.arange(c)
    arrived = np.zeros(n, bool)
    arrived[cohort] = True
    arrived[cohort[rng.integers(c)]] = False
    down = np.zeros(n, bool)
    down[rng.choice(n, size=c, replace=False)] = True
    return {"x": x, "h": h, "slot": slot, "slot_of": slot_of,
            "off": int(rng.integers(0, c)), "arrived": arrived,
            "down": down}


def _robust(kind, s):
    if kind is None:
        return None
    return ("trimmed", 1) if s >= 3 else ("median", 0)


# --------------------------------------------------------------------------
# the reference's side (one subprocess, sixteen forced host devices)
# --------------------------------------------------------------------------

REF_CODE = '''
import json
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import checkpoint
from repro.configs import registry as jreg
from repro.dist import comm_ws as jcomm, model_api as japi
from repro.dist import sharding as jshr
out = {{}}

def mesh_of(dp, mp):
    return jax.make_mesh((dp, mp), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:dp * mp])

rules = {{}}
for arch in ARCHS:
    jcfg = jreg.get_config(arch)
    shapes = jax.eval_shape(lambda: japi.init(jax.random.key(0), jcfg))
    names, _, _ = checkpoint._flatten_with_names(shapes)
    for m in MSIZES:
        mesh = mesh_of(1, m)
        for ep in (True, False):
            specs = jax.tree.leaves(
                jshr.params_pspecs(shapes, jcfg, mesh, ep),
                is_leaf=lambda s: isinstance(s, P))
            rules[f"{{arch}}/{{m}}/{{ep}}"] = [
                [nm, [e == "model" for e in sp]]
                for nm, sp in zip(names, specs)]
out["rules"] = np.asarray(json.dumps(rules))

def pspec(dim, nd):
    tr = [None] * nd
    if dim is not None:
        tr[dim] = "model"
    return P("data", *tr)

for dp, mp in MESHES:
    mesh = mesh_of(dp, mp)
    # the blocks' global coordinates, every shard's in device order (one
    # shard_map for the split leaves)
    split = [(name, shape, dim) for name, shape, dim in LEAVES
             if dim is not None]
    specs_ = [pspec(dim, len(shape)) for _, shape, dim in split]

    def body(*blocks):
        return tuple(
            jcomm._shard_coords(tuple(a.shape[1:]), tuple(shape),
                                tuple(sp)[1:], mesh)[None]
            for a, (_, shape, _), sp in zip(blocks, split, specs_))
    kss = jax.jit(shard_map(body, mesh=mesh, in_specs=tuple(specs_),
                            out_specs=(P(("data", "model")),) * len(split),
                            check_rep=False))(*[
        jnp.zeros((dp,) + tuple(shape), jnp.float32)
        for _, shape, _ in split])
    for (name, shape, dim), ks in zip(split, kss):
        ks = np.asarray(ks)
        out[f"coords/{{dp}}x{{mp}}/{{name}}"] = ks
        D = int(np.prod(shape))
        for c, s in ((3, 2), (4, 3)):
            out[f"cband/{{dp}}x{{mp}}/{{name}}/{{c}}_{{s}}"] = \\
                jcomm._cyclic_band_np((D,), c, s)[ks]
            out[f"bband/{{dp}}x{{mp}}/{{name}}/{{c}}"] = \\
                jcomm._block_leaf_band_np(D, c)[ks]
    pspecs = {{name: pspec(dim, len(shape)) for name, shape, dim in LEAVES}}
    for (n, c, s), var in ITEMS[(dp, mp)]:
        inp = _inputs(n, c, s)
        # the client dim of an input is split where dp divides it
        lead = "data" if n % dp == 0 else None
        put = lambda t: {{k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, P(lead, *tuple(pspecs[k])[1:]))) for k, v in t.items()}}
        x, h = put(inp["x"]), put(inp["h"])
        template, arr, rkind, wpol, wdown = VARIANTS[var]
        kw = dict(impl="pallas", meshed=True, mesh=mesh, pspecs=pspecs,
                  shard_kernels=False, down=jnp.asarray(inp["down"]),
                  robust=_robust(rkind, s), wire=wpol,
                  wire_seed=np.uint32(WSEED), wire_down=wdown)
        if arr:
            kw["arrived"] = jnp.asarray(inp["arrived"])
        if template == "cyclic":
            fn = lambda x, h: jcomm.cyclic_comm(
                x, h, jnp.asarray(inp["slot"]), c, s, SCALE, **kw)
        else:
            fn = lambda x, h: jcomm.blocked_comm(
                x, h, jnp.asarray(inp["off"], jnp.int32), n, s, SCALE,
                c=c, slot_of=jnp.asarray(inp["slot_of"]), **kw)
        xo, ho = jax.jit(fn)(x, h)
        for k in xo:
            key = f"{{dp}}x{{mp}}/{{n}}_{{c}}_{{s}}/{{var}}"
            out[f"{{key}}/x/{{k}}"] = np.asarray(xo[k])
            out[f"{{key}}/h/{{k}}"] = np.asarray(ho[k])
np.savez({path!r}, **out)
print("OK")
'''


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_ref") / "ref.npz")
    head = "".join(f"{k} = {v!r}\n" for k, v in (
        ("ARCHS", ARCHS), ("MSIZES", MSIZES), ("LEAVES", LEAVES),
        ("CASES", CASES), ("SCALE", SCALE), ("WSEED", WSEED),
        ("VARIANTS", VARIANTS), ("MESHES", MESHES), ("ITEMS", ITEMS)))
    code = ("import numpy as np\n" + head + inspect.getsource(_inputs)
            + inspect.getsource(_robust) + REF_CODE.format(path=path))
    subproc(code, devices=16, timeout=600)
    got = dict(np.load(path))
    got["rules"] = json.loads(str(got["rules"]))
    return got


# --------------------------------------------------------------------------
# the port's side
# --------------------------------------------------------------------------


def _specs(mp):
    return {nm: tuple(i == dim for i in range(len(shape)))
            for nm, shape, dim in LEAVES}


def _port_step(inp, n, c, s, var, mesh):
    """The port's step of a variant on the rank's rows and blocks; returns
    the ``{"x/leaf": block rows, "h/leaf": block rows}``."""
    template, arr, rkind, wpol, wdown = VARIANTS[var]
    mp, m = mesh.mp, mesh.m_index
    specs = _specs(mp)
    lshapes = [(nm, sharding.local_shape(shape, specs[nm], mp))
               for nm, shape, _ in LEAVES]
    spec = comm_ws.workspace_spec(lshapes)
    coords = [sharding.shard_coords(shape, specs[nm], mp, m)
              for nm, shape, _ in LEAVES]
    gdims = [int(np.prod(shape)) for _, shape, _ in LEAVES]
    rows = sharding.local_rows(mesh.rows if mesh.dp > 1 else None, n)
    blk = {nm: sharding.block_slices(shape, specs[nm], mp, m)
           for nm, shape, _ in LEAVES}
    k = rows.stop - rows.start
    xw = torch.empty(k, spec.d_total)
    hw = torch.empty(k, spec.d_total)
    for q, ws in (("x", xw), ("h", hw)):
        comm_ws.pack({nm: torch.from_numpy(
            np.ascontiguousarray(v[rows][(slice(None),) + blk[nm]]))
            for nm, v in inp[q].items()}, spec, ws)
    dev = torch.device("cpu")
    band = comm_ws.band_of_blocks(spec.dims, gdims, coords, template, c, s,
                                  dev)
    plan = comm_ws.wire_plan(spec.dims, wpol, c, s, band, template=template,
                             gdims=gdims, coords=coords, model=mesh.tp)
    kw = dict(down=torch.from_numpy(inp["down"]).to(torch.int32),
              arrived=(torch.from_numpy(inp["arrived"]) if arr else None),
              robust=_robust(rkind, s), wire=plan, wire_seed=WSEED,
              wire_down=wdown)
    slot_of = torch.from_numpy(inp["slot_of"])
    if mesh.dp > 1:
        slot = (torch.from_numpy(inp["slot"]) if template == "cyclic"
                else comm_ws.blocked_slot(slot_of, inp["off"], c))
        comm_ws.shard_comm(xw, hw, slot, band, c, s, SCALE,
                           group=mesh.rows, **kw)
    elif template == "cyclic":
        comm_ws.cyclic_comm(xw, hw, torch.from_numpy(inp["slot"]), band, c,
                            s, SCALE, **kw)
    else:
        comm_ws.blocked_comm(xw, hw, inp["off"], slot_of, band, c, s,
                             SCALE, **kw)
    out = {}
    for q, ws in (("x", xw), ("h", hw)):
        for nm, v in comm_ws.unpack(ws, spec).items():
            out[f"{q}/{nm}"] = v.numpy().copy()
    return out


def _layers(tp):
    """The reduced gemma2-2b's loss and gradients on a model rank's blocks
    (``tp``), or on the whole model (``tp=None``), in f32 or float64."""
    cfg = registry.get_reduced_config("gemma2-2b")
    out = {}
    for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
        if tp is not None and dt == torch.float64:
            continue
        c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
        arrays = {k: v.numpy() for k, v in
                  model_api.init(cfg, seed=0, device="cpu").items()}
        if tp is not None:  # the rank's blocks, as a rank takes them over
            arrays = convert.shard_params(arrays, cfg, tp.size, tp.rank)
        params = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dt)
                  for k, v in arrays.items()}
        for v in params.values():
            v.requires_grad_(True)
        rng = np.random.default_rng(5)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            size=(2, LAYER_SEQ)))
        lab = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            size=(2, LAYER_SEQ)))
        loss, _ = model_api.loss(params, c, tokens=tok, labels=lab, tp=tp)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[f"{tag}/loss"] = loss.detach().numpy()
        for k, g in zip(params, grads):
            out[f"{tag}/g/{k}"] = g.numpy()
    return out


def _meshes(n):
    """On 4 ranks: ``{(1, 2): the rank's pair of model ranks as a mesh of
    one data rank (its own one-rank data group), (2, 2): the whole
    mesh}``, each over a population of ``n``."""
    import torch.distributed as dist

    whole = sharding.make_mesh(n, 2, 2)
    alone = [dist.new_group([r]) for r in range(4)]
    pair = sharding.Mesh2D(1, 2, whole.m_index,
                           sharding.RankRows(n, 1, 0, alone[whole.rank]),
                           whole.tp)
    return {(1, 2): pair, (2, 2): whole}


def _rank_cases(rank, dev, out_dir):
    """Every mesh's items on 4 ranks (ranks 0 and 1 run the (1, 2) items
    and the layers on their own), then the (2, 2) items."""
    torch.set_num_threads(1)
    meshes = _meshes(5)
    out = {}
    lead = meshes[(2, 2)].d_index == 0
    for (dp, mp), mesh in meshes.items():
        if dp == 1 and not lead:
            continue
        for (n, c, s), var in ITEMS[(dp, mp)]:
            inp = _inputs(n, c, s)
            mesh.rows = sharding.RankRows(n, dp, mesh.d_index,
                                          mesh.rows.pg)
            mesh.tp.sizes.clear()
            res = _port_step(inp, n, c, s, var, mesh)
            key = f"{dp}x{mp}/{n}_{c}_{s}/{var}"
            for k, v in res.items():
                out[f"{key}/{k}"] = v
            out[f"{key}/max_sizes"] = np.asarray(mesh.tp.sizes, np.int64)
    if lead:
        for k, v in _layers(meshes[(1, 2)].tp).items():
            out[f"layers/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``{(dp, mp): [each rank's outputs of that mesh]}``: ranks 0 and 1
    for (1, 2), all four for (2, 2); one spawn."""
    tmp = str(tmp_path_factory.mktemp("tp_port"))
    sharding.spawn(_rank_cases, 4, backend="gloo", device="cpu",
                   init_method=sharding.file_init_method(tmp),
                   args=(tmp,))
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(4)]
    got = {}
    for dp, mp in MESHES:
        pre = f"{dp}x{mp}/"
        got[(dp, mp)] = [
            {(k[len(pre):] if k.startswith(pre) else k): v
             for k, v in r.items()
             if k.startswith(pre) or k.startswith("layers/")}
            for r in ranks[:dp * mp]]
    return got


def _same(a, b):
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def _err(a, b):
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def _tol(var, s, want):
    _, _, _, wpol, wdown = VARIANTS[var]
    if not (wdown and s >= 3):
        return TOL
    return max(TOL, float(np.abs(want).max()) / 127)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("msize", MSIZES)
@pytest.mark.parametrize("ep", [True, False])
def test_params_pspecs_match_the_reference(reference, msize, ep):
    for arch in ARCHS:
        want = reference["rules"][f"{arch}/{msize}/{ep}"]
        got = sharding.params_pspecs(registry.get_config(arch), msize, ep)
        assert [nm for nm, _ in want] == list(got), arch
        for nm, spec in want:
            assert list(got[nm]) == spec, (arch, nm)


@pytest.mark.parametrize("arch", ["gemma2-2b", "stablelm-3b",
                                  "deepseek-coder-33b", "gemma2-9b"])
def test_check_model_parallel_takes_the_dense_family(arch):
    cfg = registry.get_config(arch)
    for mp in (2, 4):
        sharding.check_model_parallel(cfg, mp)
    with pytest.raises(ValueError, match="A9c"):
        sharding.check_model_parallel(cfg, 16 if arch != "stablelm-3b"
                                      else 64)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "rwkv6-7b",
                                  "zamba2-2.7b", "whisper-tiny",
                                  "internvl2-26b"])
def test_check_model_parallel_refuses_the_rest(arch):
    with pytest.raises(ValueError, match="A9c"):
        sharding.check_model_parallel(registry.get_reduced_config(arch), 2)


@pytest.mark.parametrize("dp,mp", MESHES)
@pytest.mark.parametrize("name", [nm for nm, _, dim in LEAVES
                                  if dim is not None])
def test_shard_coords_and_bands_match_the_reference(reference, dp, mp,
                                                    name):
    shape = dict((nm, sh) for nm, sh, _ in LEAVES)[name]
    spec = _specs(mp)[name]
    D = int(np.prod(shape))
    ks = reference[f"coords/{dp}x{mp}/{name}"]
    for dev in range(dp * mp):
        m = dev % mp
        kt = sharding.shard_coords(shape, spec, mp, m)
        assert np.array_equal(kt.numpy(), ks[dev]), (dev, name)
        for c, s in ((3, 2), (4, 3)):
            assert np.array_equal(
                comm_ws.cyclic_band_at(kt, c, s).numpy(),
                reference[f"cband/{dp}x{mp}/{name}/{c}_{s}"][dev])
            assert np.array_equal(
                comm_ws.block_band_at(kt, D, c).numpy(),
                reference[f"bband/{dp}x{mp}/{name}/{c}"][dev])


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_leaf_scales_at_is_the_whole_leaf_scales(kind):
    """Each block's scatter-max scales (``wire.leaf_scales_at``), maxed
    over the blocks as the ``MAX`` over the model group does, are bitwise
    ``wire.leaf_scales`` of the whole leaf (held to the reference in
    ``test_torch_wire.py``), nonfinite entries included; where a block is
    whole chunks ``chunk_max_at``'s reshape form equals its scatter
    form."""
    from repro_torch.dist import wire

    rng = np.random.default_rng(3)
    for shape, spec in (((6, 100), (True, False)),
                        ((4, 1024), (False, True))):
        x = torch.from_numpy(rng.normal(size=(3,) + shape).astype(
            np.float32))
        x[0, 1, 7] = float("inf")
        x[2, -1, 3] = float("nan")
        D = int(np.prod(shape))
        nc = wire.n_chunks(D)
        got = None
        for m in range(2):
            k = sharding.shard_coords(shape, spec, 2, m)
            blk = x[(slice(None),) + sharding.block_slices(
                shape, spec, 2, m)].reshape(3, -1)
            sc = wire.leaf_scales_at(blk, k, nc, kind)
            got = sc if got is None else torch.maximum(got, sc)
            if comm_ws.whole_chunks(k):
                assert torch.equal(
                    wire.chunk_max_at(blk, k, nc, whole_chunks=True),
                    wire.chunk_max_at(blk, k, nc))
        assert torch.equal(got, wire.leaf_scales(x.reshape(3, D), kind))


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b",
                                  "whisper-tiny"])
def test_shard_and_gather_params_round_trip(arch):
    """``convert.shard_params`` cuts each rank's blocks under the rules
    and ``gather_params`` puts them back, bitwise, for 2 and 4 ranks."""
    cfg = registry.get_reduced_config(arch)
    arrays = {k: v.numpy() for k, v in
              model_api.init(cfg, seed=1, device="cpu").items()}
    for mp in (2, 4):
        ps = sharding.params_pspecs(cfg, mp)
        blocks = [convert.shard_params(arrays, cfg, mp, m)
                  for m in range(mp)]
        for name, spec in ps.items():
            assert blocks[0][name].shape == sharding.local_shape(
                arrays[name].shape, spec, mp)
        back = convert.gather_params(blocks, cfg)
        assert all(np.array_equal(back[k], v) for k, v in arrays.items())


def test_whole_leaves_have_no_coordinates():
    assert sharding.shard_coords((29,), (False,), 2, 1) is None
    assert sharding.shard_coords((4, 6), (False, False), 2, 0) is None


@pytest.mark.parametrize("dp,mp,case,var", [
    (dp, mp, case, var) for dp, mp in MESHES for case, var in ITEMS[(dp, mp)]])
def test_model_sharded_comm_step_matches_the_reference(reference, port, dp,
                                                      mp, case, var):
    n, c, s = case
    ranks = port[(dp, mp)]
    specs = _specs(mp)
    for q in ("x", "h"):
        for nm, shape, dim in LEAVES:
            want = reference[f"{dp}x{mp}/{_key(case)}/{var}/{q}/{nm}"]
            blocks = []
            for m in range(mp):
                blocks.append(np.concatenate(
                    [ranks[d * mp + m][f"{_key(case)}/{var}/{q}/{nm}"]
                     for d in range(dp)]))
            got = (np.concatenate(blocks, axis=1 + dim) if any(specs[nm])
                   else blocks[0])
            if s == 2 and q == "x" and VARIANTS[var][3] != "int8":
                assert _same(got, want), (q, nm, _err(got, want))
            else:
                assert _err(got, want) <= _tol(var, s, want), (q, nm)


@pytest.mark.parametrize("dp,mp", MESHES)
def test_one_scale_max_per_kind_group_and_step(port, dp, mp):
    """The int wire's only model-group collectives: one ``MAX`` of the
    rows' global chunk maxima for the UpCom and one of x_bar's for the
    DownCom; the mean, survivor and robust steps issue none."""
    nc = sum(-(-int(np.prod(shape)) // 256) for _, shape, _ in LEAVES)
    for rank, out in enumerate(port[(dp, mp)]):
        for (n, c, s), var in ITEMS[(dp, mp)]:
            rows = sharding.RankRows(n, dp, rank // mp).local
            sizes = list(out[f"{n}_{c}_{s}/{var}/max_sizes"])
            want = [rows * nc, nc] if VARIANTS[var][3] else []
            assert sizes == want, (rank, var, sizes)


def test_tensor_parallel_layers_match_one_process(port):
    """mp = 2: one loss on both ranks, the gathered gradients within the
    float64-derived bound of the one-process ones; the replicated norm
    scales' gradients equal on both ranks."""
    r0, r1 = port[(1, 2)]
    one = _layers(None)
    assert r0["layers/f32/loss"] == r1["layers/f32/loss"]
    l_err = abs(float(r0["layers/f32/loss"]) - float(one["f32/loss"]))
    l_ref = abs(float(one["f32/loss"]) - float(one["f64/loss"]))
    assert l_err <= TP_FACTOR * l_ref + TP_FLOOR * abs(float(one["f64/loss"]))
    cfg = registry.get_reduced_config("gemma2-2b")
    ps = sharding.params_pspecs(cfg, 2)
    grads = [{k[len("layers/f32/g/"):]: v for k, v in r.items()
              if k.startswith("layers/f32/g/")} for r in (r0, r1)]
    gathered = convert.gather_params(grads, cfg)
    for name in ps:
        got = gathered[name]
        if not any(ps[name]):
            assert np.array_equal(grads[0][name], grads[1][name]), name
        want, wide = one[f"f32/g/{name}"], one[f"f64/g/{name}"]
        err = float(np.abs(got - want).max())
        own = float(np.abs(want - wide).max())
        assert err <= TP_FACTOR * own + TP_FLOOR * float(
            np.abs(wide).max()), (name, err, own)
