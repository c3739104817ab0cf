"""The port's shard engine (``comm_ws.shard_comm``, ROADMAP A9a) on 2 and 4
gloo ranks on the CPU, against the reference's shard-resident comm step
and against the port's own one-process step.

* **Against the reference.** ``cyclic_comm``/``blocked_comm(impl=
  "pallas", meshed=True, shard_kernels=False)`` of ``repro.dist.comm_ws``
  on forced host meshes ``(dp, 1)``, dp in {2, 4} (one subprocess writes
  every output to an npz), the entry the reference's own
  ``tests/test_comm_shard.py`` drives.  Cases ``(n, c, s)`` in ``[(8, 5,
  2), (6, 4, 4), (9, 3, 3), (2, 2, 2)]``: 6 and 9 do not divide 4, and at
  n = 2 on 4 ranks two ranks hold no row; an idle row of NaN where n > c;
  a tall leaf (``D s < c``) at (8, 5, 2).  Variants: both templates, the
  mean and the survivor rebuild (one member dropped), trimmed (k = 1 at
  s >= 3, the median at s = 2) and median, the f16 and int8 wire with and
  without ``wire_down``.  Within 1e-6 (the reference test's own
  tolerance), x bitwise at s = 2 but on the int wire.  Jitted, XLA
  rounds the int wire's chunk scales otherwise than the reference's
  eager arithmetic (as ``test_torch_blocked.py`` records), which moves
  x_bar by an ulp (the int codes are held bitwise port to port), and
  where a shard holds one row it contracts the h update ``h + scale
  (x_bar - x)`` into one FMA (measured at n = 2), an ulp from the
  port's, which rounds each operation as the reference's eager ``ws``
  does.  Under ``wire_down`` at s >= 3 a reassociated x_bar within an ulp
  of a rounding boundary of the DownCom's kind lands on the neighbouring
  level: there the tolerance is one level (2**-10 of the leaf's largest
  value for f16, 1/127 for int8).
* **Against the port's one process** (``cyclic_comm``/``blocked_comm`` on
  the whole workspace): bitwise at s = 2, within 1e-6 at s >= 3 (one
  level under ``wire_down``), where the ranks' partials reassociate each
  coordinate's owner sum.  The one-process tall leaf takes the
  reference's dense form, whose mask product carries an idle row's NaN
  into x_bar, as the reference's does; the shard engine selects, as the
  reference's shard engine does: there the one-process NaN entries are
  not compared.
* **The collective bound.** Every ``all_reduce`` the engine issues
  (recorded by ``RankRows.all_reduce``) has at most ``d_total`` elements,
  or ``s`` times the column chunk on the robust combines' owner exchange;
  n = 8 > s makes the bound discriminating, and an ``(n, d)`` sum through
  the same wrapper trips it.
* ``wire_pack`` with ``row0``: the plain version's codes and scales of
  rows ``[row0, row0 + k)`` are those rows of the whole workspace's pack.

The ranks run in one ``sharding.spawn`` per world size for every case
(one intra-op thread each, a ``file://`` store under the test's temporary
directory).
"""

import inspect
import os

import numpy as np
import pytest
import torch

from repro_torch.dist import comm_ws, sharding
from repro_torch.kernels import ref, wire_pack

CASES = [(8, 5, 2), (6, 4, 4), (9, 3, 3), (2, 2, 2)]
# the leaves in the reference's (sorted-key) order
LEAVES = (("a", (13, 5)), ("b", (29,)), ("t", (1,)))
SCALE = 0.37
TOL = 1e-6
WSEED = 0xC0FFEE
# name: (template, a member dropped, robust kind, wire policy, wire_down)
VARIANTS = {
    "cyc": ("cyclic", False, None, None, False),
    "blk": ("blocked", False, None, None, False),
    "cyc_surv": ("cyclic", True, None, None, False),
    "blk_surv": ("blocked", True, None, None, False),
    "cyc_trim_surv": ("cyclic", True, "trimmed", None, False),
    "blk_median": ("blocked", False, "median", None, False),
    "cyc_int8_down_surv": ("cyclic", True, None, "int8", True),
    "cyc_f16": ("cyclic", False, None, "f16", False),
    "blk_f16_down": ("blocked", False, None, "f16", True),
    "blk_int8": ("blocked", False, None, "int8", False),
}
# the variants each case runs on 2 and 4 ranks: together every variant
# on both templates, the tall leaf (8, 5, 2) under every rebuild and wire
WORLD_VARIANTS = {
    2: {(8, 5, 2): ("cyc", "blk", "cyc_surv", "cyc_trim_surv",
                    "cyc_int8_down_surv", "cyc_f16", "blk_int8"),
        (6, 4, 4): ("cyc", "blk", "blk_surv", "blk_median",
                    "blk_f16_down"),
        (9, 3, 3): ("cyc", "blk", "cyc_trim_surv", "cyc_int8_down_surv",
                    "blk_f16_down"),
        (2, 2, 2): ("cyc", "blk_surv", "cyc_f16")},
    4: {(8, 5, 2): ("cyc", "cyc_trim_surv"),
        (6, 4, 4): ("cyc", "blk_surv"),
        (9, 3, 3): ("cyc_int8_down_surv", "blk_median"),
        (2, 2, 2): ("cyc", "blk")},
}
ITEMS = [(w, case, v) for w in (2, 4) for case in CASES
         for v in WORLD_VARIANTS[w][case]]


def _key(case):
    return "_".join(map(str, case))


def _inputs(n, c, s):
    """A case's leaves, slots and masks from a numpy stream."""
    rng = np.random.default_rng(1000 * n + 10 * c + s)
    x = {k: rng.normal(size=(n,) + shape).astype(np.float32)
         for k, shape in LEAVES}
    h = {k: rng.normal(size=(n,) + shape).astype(np.float32)
         for k, shape in LEAVES}
    cohort = np.sort(rng.choice(n, size=c, replace=False))
    slot = np.full(n, -1, np.int32)
    slot[cohort] = rng.permutation(c)
    slot_of = np.full(n, -1, np.int32)
    slot_of[cohort] = np.arange(c)
    idle = np.setdiff1d(np.arange(n), cohort)
    for k in x:
        x[k][idle[:1]] = np.nan
    arrived = np.zeros(n, bool)
    arrived[cohort] = True
    arrived[cohort[rng.integers(c)]] = False
    down = np.zeros(n, bool)
    down[rng.choice(n, size=c, replace=False)] = True
    return {"x": x, "h": h, "slot": slot, "slot_of": slot_of,
            "off": int(rng.integers(0, c)), "arrived": arrived,
            "down": down}


def _robust(kind, s):
    """The normalized robust spec of a variant: trimmed k = 1 needs s >= 3
    and is the median at s = 2."""
    if kind is None:
        return None
    if kind == "trimmed" and s >= 3:
        return ("trimmed", 1)
    return ("median", 0)


# --------------------------------------------------------------------------
# the reference's side (one subprocess, four forced host devices)
# --------------------------------------------------------------------------

REF_CODE = '''
import jax, jax.numpy as jnp, numpy as np
from repro.dist import comm_ws as jcomm
out = {{}}
for dp in (2, 4):
    mesh = jax.make_mesh((dp, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:dp])
    for n, c, s in CASES:
        inp = _inputs(n, c, s)
        x = {{k: jnp.asarray(v) for k, v in inp["x"].items()}}
        h = {{k: jnp.asarray(v) for k, v in inp["h"].items()}}
        for var in WORLD_VARIANTS[dp][(n, c, s)]:
            template, arr, rkind, wpol, wdown = VARIANTS[var]
            kw = dict(impl="pallas", meshed=True, mesh=mesh,
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
                out[f"{{dp}}/{{n}}_{{c}}_{{s}}/{{var}}/x/{{k}}"] = np.asarray(
                    xo[k])
                out[f"{{dp}}/{{n}}_{{c}}_{{s}}/{{var}}/h/{{k}}"] = np.asarray(
                    ho[k])
np.savez({path!r}, **out)
print("OK")
'''


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shard_ref") / "ref.npz")
    head = "".join(f"{k} = {v!r}\n" for k, v in (
        ("CASES", CASES), ("LEAVES", LEAVES), ("SCALE", SCALE),
        ("WSEED", WSEED), ("VARIANTS", VARIANTS),
        ("WORLD_VARIANTS", WORLD_VARIANTS)))
    code = ("import numpy as np\n" + head + inspect.getsource(_inputs)
            + inspect.getsource(_robust) + REF_CODE.format(path=path))
    subproc(code, devices=4, timeout=600)
    return dict(np.load(path))


# --------------------------------------------------------------------------
# the port's side
# --------------------------------------------------------------------------


def _spec(template, c, s):
    last = ()
    if template == "cyclic":
        last = [nm for nm, shape in LEAVES
                if int(np.prod(shape)) * s < c]
    return comm_ws.workspace_spec(LEAVES, last=last)


def _port_step(inp, n, c, s, var, group=None):
    """The port's step of a variant on the rows ``group`` holds (the shard
    engine), or on every row in one process (``group=None``); returns the
    rows' ``{"x/leaf": array, "h/leaf": array}``."""
    template, arr, rkind, wpol, wdown = VARIANTS[var]
    spec = _spec(template, c, s)
    rows = sharding.local_rows(group, n)
    k = rows.stop - rows.start
    xw = torch.empty(k, spec.d_total)
    hw = torch.empty(k, spec.d_total)
    comm_ws.pack({nm: torch.from_numpy(v[rows]) for nm, v in
                  inp["x"].items()}, spec, xw)
    comm_ws.pack({nm: torch.from_numpy(v[rows]) for nm, v in
                  inp["h"].items()}, spec, hw)
    main = spec.main_leaves
    mdims = spec.dims[:main]
    dev = torch.device("cpu")
    band = (comm_ws.cyclic_band(mdims, c, s, dev) if template == "cyclic"
            else comm_ws.block_band(mdims, c, dev))
    plan = comm_ws.wire_plan(mdims, wpol, c, s, band, template=template,
                             ids=spec.ids[:main])
    kinds = [comm_ws.wire_mod.resolve_kind(D, wpol) for D in spec.dims]
    tall = tuple((spec.ids[i], spec.offsets[i], spec.dims[i], kinds[i])
                 for i in range(main, len(spec.dims)))
    kw = dict(down=torch.from_numpy(inp["down"]).to(torch.int32),
              arrived=(torch.from_numpy(inp["arrived"]) if arr else None),
              robust=_robust(rkind, s), wire=plan, wire_seed=WSEED,
              wire_down=wdown)
    slot_of = torch.from_numpy(inp["slot_of"])
    if group is not None:
        slot = (torch.from_numpy(inp["slot"]) if template == "cyclic"
                else comm_ws.blocked_slot(slot_of, inp["off"], c))
        comm_ws.shard_comm(xw, hw, slot, band, c, s, SCALE, group=group,
                           tall=tall, **kw)
    elif template == "cyclic":
        comm_ws.cyclic_comm(xw, hw, torch.from_numpy(inp["slot"]), band, c,
                            s, SCALE, tall=tall, **kw)
    else:
        comm_ws.blocked_comm(xw, hw, inp["off"], slot_of, band, c, s,
                             SCALE, **kw)
    out = {}
    for q, ws in (("x", xw), ("h", hw)):
        for nm, v in comm_ws.unpack(ws, spec).items():
            out[f"{q}/{nm}"] = v.numpy().copy()
    return out


def _rank_cases(rank, dev, world, out_dir):
    """One rank: every case and variant of its world size, then an ``(n,
    d)`` sum through the same wrapper (the bound's positive control)."""
    torch.set_num_threads(1)
    out = {}
    for n, c, s in CASES:
        inp = _inputs(n, c, s)
        for var in WORLD_VARIANTS[world][(n, c, s)]:
            g = sharding.RankRows.of_group(n)
            res = _port_step(inp, n, c, s, var, g)
            for k, v in res.items():
                out[f"{n}_{c}_{s}/{var}/{k}"] = v
            out[f"{n}_{c}_{s}/{var}/sizes"] = np.asarray(g.sizes, np.int64)
    g = sharding.RankRows.of_group(8)
    g.all_reduce(torch.zeros(8, 95))
    out["control/sizes"] = np.asarray(g.sizes, np.int64)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``{world: {key: array}}``: each variant's rows assembled from the
    ranks in row order, its per-rank collective sizes, the control's."""
    got = {}
    for world in (2, 4):
        tmp = str(tmp_path_factory.mktemp(f"shard_w{world}"))
        sharding.spawn(_rank_cases, world, backend="gloo", device="cpu",
                       init_method=sharding.file_init_method(tmp),
                       args=(world, tmp))
        parts = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(world)]
        merged = {}
        for key in parts[0]:
            if key.endswith("sizes"):
                merged[key] = [p[key] for p in parts]
            else:
                merged[key] = np.concatenate([p[key] for p in parts])
        got[world] = merged
    return got


def _same(a, b):
    """Equal values, NaN where NaN: bitwise up to the sign of zero."""
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def _err(a, b, skip=None):
    """max |a - b| over the entries where neither is NaN and ``skip`` is
    not set; the NaN masks must agree elsewhere."""
    assert a.shape == b.shape
    skip = np.zeros(a.shape, bool) if skip is None else skip
    assert np.array_equal(np.isnan(a) & ~skip, np.isnan(b) & ~skip)
    ok = ~np.isnan(a) & ~np.isnan(b) & ~skip
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def _tol(var, s, want):
    """1e-6, or one DownCom level under ``wire_down`` at s >= 3."""
    _, _, _, wpol, wdown = VARIANTS[var]
    if not (wdown and s >= 3):
        return TOL
    top = float(np.nanmax(np.abs(want))) if np.isfinite(want).any() else 0
    return max(TOL, top * (2.0 ** -10 if wpol == "f16" else 1 / 127))


@pytest.mark.parametrize("world,case,var", ITEMS)
def test_shard_engine_matches_the_reference(reference, port, world, case,
                                            var):
    n, c, s = case
    for q in ("x", "h"):
        for nm, _ in LEAVES:
            got = port[world][f"{_key(case)}/{var}/{q}/{nm}"]
            want = reference[f"{world}/{_key(case)}/{var}/{q}/{nm}"]
            got = got.reshape(want.shape)
            if s == 2 and q == "x" and VARIANTS[var][3] != "int8":
                assert _same(got, want), (q, nm, _err(got, want))
            else:
                assert _err(got, want) <= _tol(var, s, want), (q, nm)


@pytest.mark.parametrize("world,case,var", ITEMS)
def test_shard_engine_matches_the_one_process_step(port, world, case, var):
    n, c, s = case
    spec = _spec(VARIANTS[var][0], c, s)
    tall = set(spec.names[spec.main_leaves:])
    with_one = _port_step(_inputs(n, c, s), n, c, s, var)
    for k, want in with_one.items():
        got = port[world][f"{_key(case)}/{var}/{k}"]
        skip = np.isnan(want) if k.split("/")[1] in tall else None
        if s == 2:
            assert _err(got, want, skip) == 0.0, k
        else:
            assert _err(got, want, skip) <= _tol(var, s, want), k


def _assert_bounded(sizes, bound):
    for r, per_rank in enumerate(sizes):
        assert len(per_rank) and max(per_rank) <= bound, (
            f"rank {r} issued a collective of {max(per_rank)} > {bound}")


@pytest.mark.parametrize("world,case,var", ITEMS)
def test_every_collective_is_d_sized(port, world, case, var):
    """Mean and survivor: at most d_total; robust: s x the column chunk
    (here s x d_total, each leaf's stack one chunk).  Every rank issues
    the same sizes in the same order."""
    n, c, s = case
    sizes = port[world][f"{_key(case)}/{var}/sizes"]
    d_total = _spec(VARIANTS[var][0], c, s).d_total
    bound = (s * min(d_total, ref.CHUNK) if VARIANTS[var][2]
             else d_total)
    _assert_bounded(sizes, bound)
    assert all(np.array_equal(sz, sizes[0]) for sz in sizes)


def test_the_collective_bound_trips_on_a_population_sized_sum(port):
    """The positive control: an (n, d) = (8, 95) sum through the same
    wrapper exceeds the bound of a workspace of width 95 at s = 2."""
    for world in (2, 4):
        sizes = port[world]["control/sizes"]
        assert all(list(sz) == [8 * 95] for sz in sizes)
        with pytest.raises(AssertionError):
            _assert_bounded(sizes, 2 * 95)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("row0,k", [(0, 3), (2, 3), (5, 2), (6, 1)])
def test_wire_pack_row0_draws_the_global_rows(kind, row0, k):
    """Rows [row0, row0 + k) packed alone with ``row0`` are bitwise those
    rows of the whole workspace's pack (the plain version; the kernel is
    held to it on the card)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(7, 700)).astype(np.float32))
    x[4, 3] = float("nan")
    leaves = [(0, 0, 300), (2, 300, 77), (1, 377, 323)]
    codes, scales = wire_pack.pack_int(x, leaves, kind, WSEED)
    c2, s2 = wire_pack.pack_int(x[row0:row0 + k].contiguous(), leaves,
                                kind, WSEED, row0=row0)
    assert torch.equal(c2, codes[row0:row0 + k])
    assert _same(s2.numpy(), scales[row0:row0 + k].numpy())
    if row0:
        c0, _ = wire_pack.pack_int(x[row0:row0 + k].contiguous(), leaves,
                                   kind, WSEED)
        assert not torch.equal(c0, c2)  # the row id keys the draw
