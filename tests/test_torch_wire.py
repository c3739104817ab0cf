"""The port's quantized wire against the reference (``repro.dist.wire`` and
the wire path of ``repro.dist.comm_ws``), on seeded numpy inputs:

* the counter hash (``round_seed``, ``fold_seed``, ``uniform01``) bitwise,
  with hashes at the top of the uint32 range (where the f32 conversion
  rounds up to exactly 1.0) and the DownCom row id ``DOWN_ROW``;
* ``leaf_scales``, ``narrow`` (at and beyond ±65504), ``quantize`` and
  ``quantize_to_int`` bitwise at int8 and int4, with NaN, ±inf, an
  all-zero chunk and a ragged last chunk;
* the plain ``masked_sum_dequant`` (both forms) and the f16/bf16-lane
  ``masked_sum`` bitwise against the Pallas bodies in interpret mode, with
  a NaN scale in an idle row and a NaN-poisoned chunk in an owned row;
  the group quantizer ``wire_pack.pack_int`` and ``quantize_down`` bitwise
  against ``wire.leaf_scales`` + ``quantize_to_int`` / ``quantize``;
* the comm step ``cyclic_comm(wire=, wire_seed=, wire_down=)`` against
  ``repro.dist.comm_ws.cyclic_comm(impl="pallas", meshed=False,
  block=32)`` for every wire kind and ``auto``, with DownCom rows, dropped
  members (survivor and wait-all) and the trimmed mean, within 1e-6 (the
  reference's own cross-implementation tolerance): the Pallas body
  computes ``sum / s`` as a multiplication by ``1/s``, one rounding away
  from the port's division at s=3; the survivor and robust rebuilds agree
  bitwise;
* ``wire=None`` is the f32 path bit for bit;
* one reduced gemma2-2b round with int8 and ``wire_down`` against the
  reference's per-step composition (jitted, as ``tests/test_torch_round.py``
  runs it): the local steps within 1e-5, then the comm step on the
  reference's own trained state within 1e-6.  Quantization is
  discontinuous, so the two are held apart: a last-bit difference in a
  trained coordinate may move its stochastic rounding by one level;
* the byte counters reproduce ``BENCH_quant_comm.json``'s per-client rows
  exactly, and scale by the arrived fraction on a faulted round;
* ``run_rounds`` on the wire (seeded replay, the faulted path) and the
  CLI.

The wire's unit and comm-step comparisons run the reference un-jitted:
under ``jax.jit`` XLA:CPU turns the scale's division by a constant
(``mx / 127``) into a multiplication by its reciprocal, one rounding away
from the literal division that eager JAX and the port compute (see
ROADMAP.md C).  The jitted reduced round's scales therefore differ from
the port's by one rounding in some chunks: x by at most 6e-8 and h by
2.7e-7 at these inputs, no code moved a level (run eagerly, the same
comm step agrees bitwise).
"""

import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import gemma2_2b as jgemma
from repro.dist import comm_ws as jcomm
from repro.dist import model_api as japi
from repro.dist import tamuna_dp as jtd
from repro.dist import wire as jwire
from repro.kernels import uplink as juplink
from repro_torch.configs import gemma2_2b
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import (cohort, comm_ws, faults, model_api, rounds,
                              tamuna_dp, wire)
from repro_torch.kernels import compress, uplink, wire_pack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down by 10-100x when
    they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _wseed(k):
    return int(jwire.round_seed(jax.random.fold_in(jax.random.key(k),
                                                   jwire.WIRE_FOLD)))


# --------------------------------------------------------------------------
# the counter hash
# --------------------------------------------------------------------------


def _inv_avalanche(h):
    """The input whose ``wire._avalanche`` is ``h`` (every step of the
    hash is a bijection of uint32)."""
    inv = lambda c: pow(c, -1, 1 << 32)
    h ^= h >> 16
    h = (h * inv(0x846CA68B)) & M32
    h ^= (h >> 15) ^ (h >> 30)
    h = (h * inv(0x7FEB352D)) & M32
    h ^= h >> 16
    return h


def test_round_seed_and_fold_seed_bitwise():
    for k in range(5):
        key = jax.random.fold_in(jax.random.key(k), jwire.WIRE_FOLD)
        words = np.asarray(jax.random.key_data(key)).reshape(-1).tolist()
        seed = wire.round_seed(words)
        assert seed == int(jwire.round_seed(key))
        for li in (0, 1, 7, 12, 2 ** 31 + 5):
            assert wire.fold_seed(seed, li) == int(jwire.fold_seed(seed, li))


def test_uniform01_bitwise_including_the_top_of_the_range():
    seed = _wseed(3)
    rng = np.random.default_rng(0)
    rows = np.array([0, 1, 4, 9, jwire.DOWN_ROW], np.uint32)
    coords = rng.integers(0, 2 ** 31, size=2000).astype(np.uint32)
    # coordinates whose hash is 2^32 - 1, 2^32 - 128 (both round up to
    # 2^32, u == 1.0), 2^32 - 129 (rounds down), 2^31 and 0
    for row in rows.tolist():
        h1 = wire._avalanche(seed ^ wire._mul32(row, 0x9E3779B9))
        for target in (M32, 2 ** 32 - 128, 2 ** 32 - 129, 2 ** 31, 0):
            x = _inv_avalanche(target)
            coords = np.append(coords, np.uint32(
                ((x ^ h1) * pow(0x85EBCA6B, -1, 1 << 32)) & M32))
    want = np.asarray(jwire.uniform01(jnp.uint32(seed),
                                      jnp.asarray(rows)[:, None],
                                      jnp.asarray(coords)[None, :]))
    got = wire.uniform01(seed,
                         torch.from_numpy(rows.astype(np.int64))[:, None],
                         torch.from_numpy(coords.astype(np.int64))[None, :])
    assert _bits_equal(got.numpy(), want)
    assert (want == 1.0).sum() == 2 * len(rows)
    assert want.max() == 1.0 and want.min() == 0.0


# --------------------------------------------------------------------------
# scales, narrowing, quantization
# --------------------------------------------------------------------------


def _payload(rows=6, d=900, seed=0):
    # the shapes of the comm-step tests' leaves, whose eager reference
    # operations are then compiled once
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d))
         * np.exp(2 * rng.normal(size=(rows, 1)))).astype(np.float32)
    x[0, 5] = np.nan
    x[1, 300] = np.inf
    x[2, 890] = -np.inf  # the ragged last chunk
    x[1, 512:768] = 0.0  # an all-zero chunk
    x[2, 0] = -0.0
    return x


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_leaf_scales_and_int_quantizers_bitwise(kind):
    x = _payload()
    rows, d = x.shape
    seed = _wseed(1)
    sj = jwire.leaf_scales(jnp.asarray(x), kind)
    st = wire.leaf_scales(torch.from_numpy(x), kind)
    assert _bits_equal(st.numpy(), sj)
    kk = np.arange(d, dtype=np.int32)
    rid = np.arange(rows, dtype=np.uint32)[:, None]
    qj, scj = jwire.quantize_to_int(
        jnp.asarray(x), kind, jnp.uint32(seed), jnp.asarray(rid),
        jnp.asarray(kk), sj, jnp.asarray(kk // 256))
    qt, sct = wire.quantize_to_int(
        torch.from_numpy(x), kind, seed, torch.arange(rows)[:, None],
        torch.arange(d), st, torch.arange(d) // 256)
    assert qt.dtype == torch.int8 and _bits_equal(qt.numpy(), qj)
    assert _bits_equal(sct.numpy(), scj)
    # the chunks that hold NaN or an infinity are poisoned, no other
    assert np.isnan(sct.numpy()).sum() == 3
    lv = wire.LEVELS[kind]
    assert np.abs(qt.numpy()).max() <= lv
    # the DownCom form: one row keyed DOWN_ROW, nonfinite passed through
    dj = jwire.quantize(jnp.asarray(x), kind, jnp.uint32(seed),
                        jnp.full((1, 1), jwire.DOWN_ROW, jnp.uint32),
                        jnp.asarray(kk))
    dt = wire.quantize(torch.from_numpy(x), kind, seed, wire.DOWN_ROW)
    assert _bits_equal(dt.numpy(), dj)
    assert np.isinf(dt.numpy()).sum() == 2 and np.isnan(dt.numpy()).sum() == 1


@pytest.mark.parametrize("kind", ["f16", "bf16"])
def test_narrow_bitwise_at_and_beyond_the_f16_range(kind):
    x = _payload()
    x[0, :6] = [65504.0, 65519.0, 65520.0, 1e38, -7e4, -3e38]
    got = wire.narrow(torch.from_numpy(x), kind).float().numpy()
    want = np.asarray(jwire.narrow(jnp.asarray(x), kind).astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    assert _bits_equal(got[live], want[live])
    if kind == "f16":  # finite payloads stay finite
        assert np.isfinite(got[np.isfinite(x)]).all()
    dq = wire.quantize(torch.from_numpy(x), kind).numpy()
    assert _bits_equal(dq[live], want[live])


def test_leaf_byte_accounting_matches_reference():
    for kind in wire.WIRE_KINDS:
        for nnz, d, c in ((10, 17, 1), (600, 1000, 3), (1, 256, 4)):
            assert wire.leaf_up_bytes(nnz, d, c, kind) == \
                jwire.leaf_up_bytes(nnz, d, c, kind)
            assert wire.leaf_down_bytes(d, kind) == \
                jwire.leaf_down_bytes(d, kind)
    for D in (1, 65536, 65537, 10 ** 6):
        for pol in wire.WIRE_POLICIES + (None,):
            assert wire.resolve_kind(D, pol) == jwire.resolve_kind(D, pol)


# --------------------------------------------------------------------------
# the kernels' plain versions against the Pallas bodies
# --------------------------------------------------------------------------

DIMS = (4097, 30, 8000, 200)
DW, MW = sum(DIMS), 4


def _dequant_inputs(slot, seed=0):
    rng = np.random.default_rng(seed)
    n = len(slot)
    codes = rng.integers(-127, 128, size=(n, DW)).astype(np.int8)
    nc = sum(wire.n_chunks(D) for D in DIMS)
    scales = rng.random(size=(n, nc)).astype(np.float32)
    scales[1] = np.nan  # an idle or dropped row's chunks: must not leak
    scales[0, 3] = np.nan  # a poisoned chunk of an owned row
    band = rng.integers(0, MW, size=(DW,)).astype(np.int32)
    lo = torch.tensor(np.concatenate([[0], np.cumsum(DIMS)]),
                      dtype=torch.int64)
    return codes, scales, band, lo


@pytest.mark.parametrize("counts,s,slot", [
    (False, 2, [2, -1, 0, 3, 1]),
    (True, 2, [2, -1, 0, 3, 1]),
    (True, 3, [2, -1, 0, -1, 3, 1]),
])
def test_masked_sum_dequant_matches_pallas_interpret_bitwise(counts, s,
                                                             slot):
    slot = np.asarray(slot, np.int32)
    codes, scales, band, lo = _dequant_inputs(slot)
    chunk = jcomm._wire_chunkcol_np(DIMS)
    assert np.array_equal(compress.chunk_cols(lo, 0, DW).numpy(), chunk)
    want = juplink.masked_sum_dequant(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(chunk),
        jnp.asarray(slot), jnp.asarray(band), MW, s, counts=counts,
        interpret=True)
    got = uplink.masked_sum_dequant(
        torch.from_numpy(codes), torch.from_numpy(scales), lo,
        torch.from_numpy(slot), torch.from_numpy(band), MW, s,
        counts=counts)
    if not counts:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert _bits_equal(g.numpy(), w)
    # row 0's poisoned chunk (coordinates 768:1024) reaches exactly the
    # coordinates row 0 owns; row 1's NaN scales reach nothing
    own0 = compress.owned_from_band(torch.tensor(int(slot[0])),
                                    torch.from_numpy(band), MW, s).numpy()
    want_nan = np.zeros(DW, bool)
    want_nan[768:1024] = own0[768:1024]
    np.testing.assert_array_equal(np.isnan(got[0].numpy()), want_nan)


@pytest.mark.parametrize("lane", ["f16", "bf16"])
@pytest.mark.parametrize("counts,s,slot", [
    (False, 2, [2, -1, 0, 3, 1]),
    (True, 3, [2, -1, 0, -1, 3, 1]),
])
def test_narrow_lane_masked_sum_matches_pallas_interpret_bitwise(
        lane, counts, s, slot):
    slot = np.asarray(slot, np.int32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(len(slot), DW)).astype(np.float32)
    x[1] = np.nan
    xj = jnp.asarray(x).astype(jnp.float16 if lane == "f16"
                               else jnp.bfloat16)
    xt = wire.narrow(torch.from_numpy(x), lane)
    assert _bits_equal(xt.float().numpy()[0], xj.astype(jnp.float32)[0])
    band = rng.integers(0, MW, size=(DW,)).astype(np.int32)
    want = juplink.masked_sum(xj, jnp.asarray(slot), jnp.asarray(band), MW,
                              s, counts=counts, interpret=True)
    got = uplink.masked_sum(xt, torch.from_numpy(slot),
                            torch.from_numpy(band), MW, s, counts=counts)
    if not counts:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert _bits_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_group_quantizer_matches_reference_leaf_by_leaf(kind):
    rng = np.random.default_rng(2)
    dims = (900, 13, 50)
    offs = np.concatenate([[0], np.cumsum(dims)])
    x = rng.normal(size=(6, offs[-1])).astype(np.float32)
    x[3, 700] = np.nan
    x[1, 905:908] = np.inf  # the 13-coordinate leaf
    leaves = [(0, int(offs[0]), 900), (5, int(offs[2]), 50)]
    seed = _wseed(4)
    codes, scales = wire_pack.pack_int(torch.from_numpy(x), leaves, kind,
                                       seed)
    g0 = c0 = 0
    for li, o, D in leaves:
        f = jnp.asarray(x[:, o:o + D])
        sc = jwire.leaf_scales(f, kind)
        kk = jnp.arange(D, dtype=jnp.int32)
        q, sc = jwire.quantize_to_int(
            f, kind, jwire.fold_seed(seed, li),
            jnp.arange(6, dtype=jnp.uint32)[:, None], kk, sc, kk // 256)
        assert _bits_equal(codes[:, g0:g0 + D].numpy(), q)
        nc = wire.n_chunks(D)
        assert _bits_equal(scales[:, c0:c0 + nc].numpy(), sc)
        g0, c0 = g0 + D, c0 + nc
    assert codes.shape == (6, g0) and scales.shape == (6, c0)
    # the DownCom form, in place on a row, leaves outside untouched
    xb = x[2].copy()
    xb[5] = np.inf
    got = torch.from_numpy(xb.copy())
    wire_pack.quantize_down(got, leaves, kind, seed)
    want = xb.copy()
    for li, o, D in leaves:
        want[o:o + D] = np.asarray(jwire.quantize(
            jnp.asarray(xb[None, o:o + D]), kind,
            jwire.fold_seed(seed, li),
            jnp.full((1, 1), jwire.DOWN_ROW, jnp.uint32),
            jnp.arange(D, dtype=jnp.int32)))[0]
    assert _bits_equal(got.numpy(), want)
    assert got[5] == np.inf and _bits_equal(got[900:913], xb[900:913])


# --------------------------------------------------------------------------
# the comm step against the reference's kernel path
# --------------------------------------------------------------------------


def _tree(n, seed, big=False):
    rng = np.random.default_rng(seed)
    t = {"a": rng.normal(size=(n, 3, 300)).astype(np.float32),
         "b": rng.normal(size=(n, 50)).astype(np.float32),
         "c": rng.normal(size=(n, 3)).astype(np.float32)}
    if big:  # past the auto threshold: an int8 leaf beside the f16 ones
        t["d"] = rng.normal(size=(n, 70001)).astype(np.float32)
    return t


def _ws(tree):
    n = tree["a"].shape[0]
    return np.concatenate([np.asarray(tree[k]).reshape(n, -1)
                           for k in sorted(tree)], axis=1)


def _port_wire_comm(tree, htree, slot, c, s, scale, policy, seed, **kw):
    ws, hs = torch.from_numpy(_ws(tree)), torch.from_numpy(_ws(htree))
    dims = [int(np.prod(tree[k].shape[1:])) for k in sorted(tree)]
    band = comm_ws.cyclic_band(dims, c, s, "cpu")
    plan = comm_ws.wire_plan(dims, policy, c, s, band)
    comm_ws.cyclic_comm(ws, hs, torch.from_numpy(slot), band, c, s, scale,
                        wire=plan, wire_seed=seed, **kw)
    return ws.numpy(), hs.numpy()


CASES = [(p, m, wd) for p in ("f16", "bf16", "int8", "int4", "auto")
         for m, wd in (("mean", True), ("survivor", True),
                       ("robust", False))]
CASES += [("int8", "mean", False), ("int8", "wait_all", True),
          ("int4", "robust_survivor", True)]


@pytest.mark.parametrize("policy,mode,wire_down", CASES)
def test_wire_comm_matches_reference_pallas(policy, mode, wire_down):
    n, c, s = 6, 4, 3
    big = policy == "auto"
    tree, htree = _tree(n, 1, big), _tree(n, 11, big)
    rng = np.random.default_rng(2)
    ids = np.sort(rng.choice(n, c, replace=False))
    slot = np.full(n, -1, np.int32)
    slot[ids] = rng.permutation(c)
    idle = np.setdiff1d(np.arange(n), ids)
    tree["b"][idle[0]] = np.nan  # an idle row may hold anything
    tree["a"][ids[1], 0, 5] = np.inf  # an owned nonfinite payload
    down = np.zeros(n, bool)
    down[ids[1:]] = True
    jkw, tkw = {}, {}
    if mode in ("survivor", "wait_all", "robust_survivor"):
        arrived = np.ones(n, bool)
        arrived[ids[0]] = False
        for k in tree:  # a dropped member may hold anything
            tree[k][ids[0]] = np.nan
        correct = mode != "wait_all"
        jkw = dict(arrived=jnp.asarray(arrived), correct=correct)
        tkw = dict(arrived=torch.from_numpy(arrived), correct=correct)
    rob = ("trimmed", 1) if mode.startswith("robust") else None
    seed = _wseed(7)
    want = jcomm.cyclic_comm(
        {k: jnp.asarray(v) for k, v in tree.items()},
        {k: jnp.asarray(v) for k, v in htree.items()},
        jnp.asarray(slot), c, s, 0.5, impl="pallas", meshed=False, block=32,
        down=jnp.asarray(down), robust=rob, wire=policy,
        wire_seed=jnp.uint32(seed), wire_down=wire_down, **jkw)
    got = _port_wire_comm(tree, htree, slot, c, s, 0.5, policy, seed,
                          down=torch.from_numpy(down).to(torch.int32),
                          robust=rob, wire_down=wire_down, **tkw)
    for g, w in zip(got, want):
        w = _ws({k: np.asarray(v) for k, v in w.items()})
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        if mode not in ("mean", "wait_all"):  # no division by s: same bits
            assert _bits_equal(g, w)


def test_f32_wire_is_the_unquantized_path_bitwise():
    n, c, s = 6, 4, 2
    tree, htree = _tree(n, 3), _tree(n, 4)
    slot = np.array([1, -1, 0, 3, 2, -1], np.int32)
    dims = [int(np.prod(tree[k].shape[1:])) for k in sorted(tree)]
    band = comm_ws.cyclic_band(dims, c, s, "cpu")
    assert comm_ws.wire_plan(dims, "f32", c, s, band) is None
    assert comm_ws.wire_plan(dims, None, c, s, band) is None
    down = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int32)
    ws, hs = torch.from_numpy(_ws(tree)), torch.from_numpy(_ws(htree))
    xk, hk = ws.clone(), hs.clone()
    comm_ws.cyclic_comm(ws, hs, torch.from_numpy(slot), band, c, s, 0.5,
                        down=down, wire=None, wire_seed=12345,
                        wire_down=True)
    # the f32 path: the mean UpCom and one h update, nothing else
    x_bar = uplink.masked_sum(xk, torch.from_numpy(slot), band, c, s)
    uplink.h_update(xk, hk, x_bar, torch.from_numpy(slot), band, c, s, 0.5,
                    down=down)
    assert _bits_equal(ws.numpy(), xk.numpy())
    assert _bits_equal(hs.numpy(), hk.numpy())


# --------------------------------------------------------------------------
# a reduced gemma2-2b round against the reference's per-step composition
# --------------------------------------------------------------------------

N, C, S, L = 4, 3, 2, 1
SEQ, BATCH = 16, 2
COHORT = [0, 2, 3]
DOWN = np.array([True, True, False, True])


@pytest.fixture(scope="module")
def reference():
    jcfg = jgemma.REDUCED
    tcfg = jtd.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34,
                                wire_precision="int8", wire_down=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = japi.init(jax.random.key(0), jcfg)
    names, leaves, treedef = checkpoint._flatten_with_names(params)
    rng = np.random.default_rng(7)
    x0 = [np.asarray(a)[None] + 0.01 * rng.normal(
        size=(N,) + a.shape).astype(np.float32) for a in leaves]
    x0 = [a.astype(np.float32) for a in x0]
    x0[0][1] = np.nan  # row 1 is idle and downloads: anything goes
    h0 = [0.01 * rng.normal(size=(N,) + a.shape).astype(np.float32)
          for a in leaves]
    h0 = [(a - a.mean(axis=0, keepdims=True)).astype(np.float32)
          for a in h0]
    toks = rng.integers(0, jcfg.vocab, size=(L, C, BATCH, SEQ + 1))
    key = jax.random.key(11)
    _, k_perm = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_perm, C))
    unflat = lambda ls: jax.tree.unflatten(treedef,
                                           [jnp.asarray(a) for a in ls])
    zero = jnp.zeros((), jnp.float32)
    state = jtd.DistTamunaState(
        x=unflat(x0), h=unflat(h0), opt=(), round=jnp.zeros((), jnp.int32),
        up_floats=zero, down_floats=zero, up_bytes=zero, down_bytes=zero)
    local = jax.jit(jtd.make_local_step(jcfg, tcfg))
    cohort_j = jnp.asarray(COHORT, jnp.int32)
    compact = jtd.gather_cohort(state, cohort_j)
    for t in range(L):
        tk = jnp.asarray(toks[t].astype(np.int32))
        compact, _ = local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
    trained = jtd.scatter_cohort(state, compact, cohort_j)
    comm = jtd.make_comm_step(jcfg, tcfg, mesh, impl="ws", n=N)
    out = jax.jit(comm)(trained, key, cohort=cohort_j,
                        down=jnp.asarray(DOWN))
    return dict(
        names=names, x0=x0, h0=h0, toks=toks, perm=perm,
        seed=int(jwire.round_seed(jax.random.fold_in(key, jwire.WIRE_FOLD))),
        trained=[np.asarray(a) for a in jax.tree.leaves(trained.x)],
        out=out, kinds=comm.wire_kinds)


def _port_state(ref, x_leaves):
    cfg = gemma2_2b.REDUCED
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    assert list(spec.names) == ref["names"]
    x = torch.empty(N, spec.d_total)
    h = torch.empty(N, spec.d_total)
    comm_ws.pack({k: torch.from_numpy(a) for k, a in
                  zip(ref["names"], x_leaves)}, spec, x)
    comm_ws.pack({k: torch.from_numpy(a) for k, a in
                  zip(ref["names"], ref["h0"])}, spec, h)
    return tamuna_dp.DistTamunaState(x=x, h=h, spec=spec)


def test_int8_wire_down_round_matches_reference_per_step(reference):
    ref = reference
    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34,
                                      wire_precision="int8", wire_down=True)
    # the local steps
    state = _port_state(ref, ref["x0"])
    local = tamuna_dp.make_local_step(cfg, tcfg)
    compact = tamuna_dp.gather_cohort(state, COHORT)
    for t in range(L):
        tk = torch.from_numpy(ref["toks"][t]).long()
        local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
    got = comm_ws.unpack(state.x, state.spec)
    for name, w in zip(ref["names"], ref["trained"]):
        live = ~np.isnan(w)
        assert np.array_equal(np.isnan(got[name].numpy()), ~live), name
        assert np.abs(got[name].numpy()[live] - w[live]).max() <= 1e-5, name
    # the comm step on the reference's trained state
    state = _port_state(ref, ref["trained"])
    comm = tamuna_dp.make_comm_step(cfg, tcfg, N, device="cpu")
    assert comm.wire_kinds == tuple(ref["kinds"])
    state = comm(state, COHORT, ref["perm"].tolist(), torch.from_numpy(DOWN),
                 wire_seed=ref["seed"])
    want = ref["out"]
    gx = comm_ws.unpack(state.x, state.spec)
    gh = comm_ws.unpack(state.h, state.spec)
    for name, wx, wh in zip(ref["names"], jax.tree.leaves(want.x),
                            jax.tree.leaves(want.h)):
        wx, wh = np.asarray(wx), np.asarray(wh)
        np.testing.assert_array_equal(np.isnan(gx[name].numpy()),
                                      np.isnan(wx))
        np.testing.assert_allclose(gx[name].numpy(), wx, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gh[name].numpy(), wh, rtol=0, atol=1e-6)
    # the downloaded rows hold Q(x_bar): on the int8 grid of each chunk
    assert _bits_equal(state.x[0].numpy(), state.x[1].numpy())
    for k in ("up_floats", "down_floats", "up_bytes", "down_bytes"):
        assert getattr(state, k) == float(getattr(want, k)), k


# --------------------------------------------------------------------------
# byte accounting
# --------------------------------------------------------------------------


def _bench_rows():
    with open(os.path.join(REPO, "BENCH_quant_comm.json")) as f:
        bench = json.load(f)["meshed"]
    return {r["policy"]: r for r in bench["bytes_rows"]}, bench


def _one_round_bytes(policy, wire_down=False, arrived=None):
    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34,
                                      wire_precision=policy,
                                      wire_down=wire_down)
    state = tamuna_dp.init_state(cfg, tcfg, 4, seed=0, device="cpu")
    comm = tamuna_dp.make_comm_step(cfg, tcfg, 4, device="cpu")
    state = comm(state, [0, 1, 3], [1, 2, 0], arrived=arrived, wire_seed=9)
    return state, comm


@pytest.mark.parametrize("policy", ["f32", "bf16", "f16", "int8", "auto"])
def test_per_client_bytes_reproduce_bench_quant_comm(policy):
    rows, _ = _bench_rows()
    state, comm = _one_round_bytes(policy)
    row = rows[policy]
    assert state.up_bytes == row["up_bytes_per_round"]
    assert state.down_bytes == row["down_bytes_per_round"] == 5252096.0
    assert state.up_floats == row["up_floats_per_round"] == 875356.0
    kinds = {k: comm.wire_kinds.count(k) for k in set(comm.wire_kinds)}
    assert kinds == row["leaf_kind_counts"]
    if policy != "f32":  # the DownCom at the wire's width
        down, _ = _one_round_bytes(policy, wire_down=True)
        dims = comm_ws.workspace_spec(
            model_api.param_specs(gemma2_2b.REDUCED)).dims
        want = sum(jwire.leaf_down_bytes(D, jwire.resolve_kind(D, policy))
                   for D in dims)
        assert down.down_bytes == want < 5252096.0


def test_int8_up_bytes_ratio_and_the_arrived_fraction():
    rows, bench = _bench_rows()
    f32, _ = _one_round_bytes("f32")
    int8, _ = _one_round_bytes("int8")
    ratio = f32.up_bytes / int8.up_bytes
    assert round(ratio, 3) == 3.908
    assert ratio == bench["up_bytes_ratio_int8_vs_f32"]
    # a faulted round: 2 of the 3 members arrived
    arrived = np.array([True, False, True, True])
    part, _ = _one_round_bytes("int8", arrived=arrived)
    assert part.up_bytes == int8.up_bytes * 2.0 / 3
    assert part.down_bytes == int8.down_bytes


# --------------------------------------------------------------------------
# the round driver and the CLI
# --------------------------------------------------------------------------


def _run(rounds_n, n=4, c=3, s=2, **kw):
    cfg = gemma2_2b.REDUCED
    tkw = {k: kw.pop(k) for k in ("wire_precision", "wire_down") if k in kw}
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=s, p=0.5, **tkw)
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=16, per_client_batch=1, vocab=64, seed=0,
                   n_clients=n), cfg, "cpu")
    return rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=rounds_n,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=2, **kw)


def test_wire_seeds_are_a_replayable_stream():
    a = [rounds.wire_seed(1, g, t) for g in range(3) for t in range(2)]
    assert a == [rounds.wire_seed(1, g, t) for g in range(3)
                 for t in range(2)]
    assert len(set(a)) == len(a) and all(0 <= v <= M32 for v in a)
    s0, rows0 = _run(2, wire_precision="auto", wire_down=True)
    s1, rows1 = _run(2, wire_precision="auto", wire_down=True)
    assert _bits_equal(s0.x.numpy(), s1.x.numpy())
    assert _bits_equal(s0.h.numpy(), s1.h.numpy())
    assert all(math.isfinite(r["loss"]) for r in rows0)
    _, rows_f32 = _run(2)
    assert rows0[-1]["up_bytes"] < rows_f32[-1]["up_bytes"]


def test_faulted_wire_round_keeps_uncovered_coordinates_untouched():
    n, c, s = 5, 4, 3
    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=s, p=0.5,
                                      wire_precision="int8", wire_down=True)
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    state.x.add_(torch.from_numpy(np.random.default_rng(0).normal(
        size=tuple(state.x.shape)).astype(np.float32)))
    state.x[2] = float("nan")  # a dropped member
    x0, h0 = state.x.clone(), state.h.clone()
    comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device="cpu")
    # one arrived owner of three: a quarter of the coordinates uncovered
    arrived = np.array([True, False, False, False, False])
    state = comm(state, [0, 1, 2, 4], [0, 1, 2, 3], arrived=arrived,
                 wire_seed=3)
    num, cnt = uplink.masked_sum(
        x0, torch.tensor([0, -1, -1, -1, -1], dtype=torch.int32),
        comm_ws.cyclic_band(state.spec.dims, c, s, "cpu"), c, s,
        counts=True)
    unc = (cnt == 0).numpy()
    assert 0.2 < unc.mean() < 0.3
    assert _bits_equal(state.x.numpy()[:, unc], x0.numpy()[:, unc])
    assert _bits_equal(state.h.numpy()[:, unc], h0.numpy()[:, unc])
    assert np.isfinite(state.x.numpy()[:, ~unc]).all()
    # the driver's faulted path on the wire
    _, rows = _run(3, n=n, c=c, s=s, wire_precision="int8",
                   plan=cohort.CohortPlan(0, n, c),
                   faults=faults.FaultPlan(seed=0, n=n, p_drop=0.25),
                   policy="quorum")
    assert all(math.isfinite(r["loss"]) and r["arrivals"] >= 3
               for r in rows)


def _cli(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # as _one_torch_thread
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_train_cli_wire_runs_on_cpu_and_refuses_wire_down_alone():
    proc = _cli(["--reduced", "--rounds", "2", "--wire-precision", "int8",
                 "--wire-down", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"final loss (\S+)$", proc.stdout.strip())
    assert m and math.isfinite(float(m.group(1))), proc.stdout
    assert "up_bytes=" in proc.stderr
    bad = _cli(["--reduced", "--rounds", "1", "--wire-down", "--device",
                "cpu"])
    assert bad.returncode != 0 and "non-f32" in bad.stderr
