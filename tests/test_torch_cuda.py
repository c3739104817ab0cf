"""The port's CUDA kernels against their plain versions on the card, at a
small ragged width with an idle row of NaN.  These tests need an NVIDIA GPU
with nvcc (``-m cuda``) and skip elsewhere; ``chip_smoke.py`` repeats the
comparison at the main path's full shapes.

Every kernel repeats its plain version's arithmetic operation for
operation with no FMA contraction, so they agree bitwise (NaN where the
plain version has NaN).  The wire's kernels are held the same way: the
dequantizing UpComs with NaN scales in idle and owned rows, the f16/bf16
lanes, the quantizer in its int8, int4 and DownCom forms, and a wire comm
step on the card against the same step on the CPU.  The convex core's
``compress`` is held bitwise in both ranks and types, and five convex rounds
on the card against the CPU within 1e-10 relative (cuBLAS and the CPU sum
the gradients' products in other orders).  Decode attention is not bitwise:
its online softmax adds in another order than the plain version's one-shot
softmax, so it is held within one bf16 ulp (bf16 outputs) or 2e-5 (f32).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref, uplink
from repro_torch.kernels.local_step import fused_local_step

pytestmark = pytest.mark.cuda

N, D, M, S = 5, 3 * 4096 + 77, 4, 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x[1] = np.nan
    h = rng.normal(size=(N, D)).astype(np.float32)
    band = rng.integers(0, M, size=(D,)).astype(np.int32)
    slot = np.array([2, -1, 0, 3, 1], np.int32)
    return [torch.from_numpy(a).to(dev) for a in (x, h, band, slot)]


@pytest.mark.parametrize("down", [None, [1, 0, 1, 0, 1]])
def test_h_update_kernel_matches_plain(dev, down):
    x, h, band, slot = _inputs(dev, 1)
    x_bar = uplink.masked_sum(x, slot, band, M, S)
    down_t = None if down is None else torch.tensor(
        down, dtype=torch.int32, device=dev)
    xk, hk = x.clone(), h.clone()
    uplink.h_update(xk, hk, x_bar, slot, band, M, S, 0.37, down=down_t)
    ref.h_update(x, h, x_bar, slot, band, M, S, 0.37, down=down_t)
    torch.cuda.synchronize()
    assert torch.equal(hk, h)
    assert torch.equal(xk.nan_to_num(7.0), x.nan_to_num(7.0))
    assert torch.equal(xk.isnan(), x.isnan())


@pytest.mark.parametrize("shape", [(D,), (37, 129), (256, 2304)])
def test_local_step_kernel_matches_plain(dev, shape):
    g = torch.Generator(device=dev).manual_seed(3)
    x, gr, h = (torch.randn(shape, generator=g, device=dev)
                for _ in range(3))
    want = ref.fused_local_step(x, gr, h, 0.05)
    got = fused_local_step(x, gr, h, 0.05)
    fused_local_step(x, gr, h, 0.05, out=x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(x, want)


def _same(a, b):
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


# The f32/f16/bf16 UpComs and the robust UpCom at their edges: n rows with
# idle and dropped rows of NaN; "aligned": every 512-column warp block on
# the vector path but the ragged last one (d not a multiple of 512);
# "offgrid": d % 4 != 0, so rows leave the vector grid and every column
# takes the scalar path; "offptr": a view whose pointer is off the grid;
# "outside": bands outside [0, m), negative and >= m, sending some blocks
# back to the scalar path; "ragged5": the single-shape inputs of the
# earlier tests (``_inputs``, d % 4 == 1).
_MS_LAYOUTS = ("aligned", "offgrid", "offptr", "outside")
_MS_SLOTS = {1: [1], 4: [2, -1, 0, 3], 5: [2, -1, 0, 3, 1],
             9: [2, -1, 0, 3, 1, -1, 3, 2, 0]}
_MS_WIDTH = {"aligned": 3 * 4096 + 260, "offgrid": 3 * 4096 + 77,
             "offptr": 3 * 4096 + 260, "outside": 3 * 4096 + 260}


def _edge_inputs(dev, n, layout, m, slots, seed, dtype=torch.float32):
    """``(x, slot, band)`` of ``n`` rows at ``layout``; rows whose slot is
    outside [0, m) hold NaN, and x has -0.0 entries."""
    if layout == "ragged5":
        x, _, band, slot = _inputs(dev, seed)
        return x.to(dtype), slot, band
    d = _MS_WIDTH[layout]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, ::13] = -0.0
    slot = np.array(slots, np.int32)
    x[(slot < 0) | (slot >= m)] = np.nan
    band = rng.integers(0, m, size=d).astype(np.int32)
    if layout == "outside":
        band[::97] = -3
        band[5::89] = m + 3
        band[7::1001] = -m - 1
    xt = torch.from_numpy(x).to(dev, dtype)
    if layout == "offptr":
        buf = torch.empty(n * d + 1, dtype=dtype, device=dev)
        buf[1:].copy_(xt.reshape(-1))
        xt = buf[1:].view(n, d)
    return (xt, torch.from_numpy(slot).to(dev),
            torch.from_numpy(band).to(dev))


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("n,layout", [(n, layout) for n in (1, 4, 5, 9)
                                      for layout in _MS_LAYOUTS]
                         + [(5, "ragged5")])
@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("lane", [torch.float32, torch.float16,
                                  torch.bfloat16])
def test_masked_sum_kernel_bitwise_at_its_edges(dev, lane, counts, n,
                                                layout):
    x, slot, band = _edge_inputs(dev, n, layout, M, _MS_SLOTS[n], 10 + n,
                                 lane)
    name = (("masked_sum_counts" if counts else "masked_sum")
            + uplink._LANE_NAME[lane])
    before = _build.launch_counts[name]
    got = uplink.masked_sum(x, slot, band, M, S, counts=counts)
    assert _build.launch_counts[name] == before + 1
    want = (ref.masked_sum_counts(x, slot, band, M, S) if counts
            else ref.masked_sum(x, slot, band, M, S))
    torch.cuda.synchronize()
    if not counts:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kind", ["trimmed", "median"])
@pytest.mark.parametrize("s,layout", [(s, layout) for s in (1, 3, 4, 8, 16)
                                      for layout in _MS_LAYOUTS]
                         + [(3, "ragged5"), (4, "ragged5")])
def test_robust_sum_kernel_bitwise_at_its_edges(dev, s, layout, kind):
    """n = s + 2 rows over m = s + 2 template columns (``ragged5``: the
    earlier single-shape inputs at m = 4): a dropped and an idle row of
    NaN, ties, +-inf, -0.0 and +0.0, an owned NaN, all-+inf columns; the
    trimmed mean trims (s - 1) // 2 per side."""
    k = (s - 1) // 2 if kind == "trimmed" else 0
    m = M if layout == "ragged5" else s + 2
    cols = np.random.default_rng(s).permutation(m)[:s].tolist()
    slots = [cols[0], -1] + cols[1:] + [-1]
    x, slot, band = _edge_inputs(dev, s + 2, layout, m, slots, 20 + s)
    act = [i for i, v in enumerate(slot.tolist()) if 0 <= v < m]
    x[act[-1], ::7] = x[act[0], ::7]  # ties
    x[act[0], ::101] = float("inf")
    x[act[-1], 50::101] = float("-inf")
    x[act[-1], 9::57] = float("nan")  # an owned NaN
    x[act[0], 3::29] = 0.0
    x[act[-1], 3::29] = -0.0
    x[act, 11::211] = float("inf")
    before = _build.launch_counts["robust_sum"]
    bar, cnt = uplink.robust_sum(x, slot, band, m, s, kind=kind, k=k)
    assert _build.launch_counts["robust_sum"] == before + 1
    bar_p, cnt_p = ref.robust_sum(x, slot, band, m, s, kind, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(cnt), _bits(cnt_p))
    nan = bar.isnan()
    assert torch.equal(nan, bar_p.isnan()) and bool(nan.any())
    assert torch.equal(_bits(bar.masked_fill(nan, 0.0)),
                       _bits(bar_p.masked_fill(nan, 0.0)))
    assert bool(bar.isinf().any())


@pytest.mark.parametrize("down", [None, [1, 0, 1, 0, 1]])
def test_h_update_covered_kernel_matches_plain(dev, down):
    x, h, band, _ = _inputs(dev, 3)
    slot = torch.tensor([1, -1, -1, -1, -1], dtype=torch.int32, device=dev)
    x_bar, cnt = uplink.masked_sum(x, slot, band, M, S, counts=True)
    covered = cnt > 0
    assert not bool(covered.all())
    down_t = None if down is None else torch.tensor(
        down, dtype=torch.int32, device=dev)
    xk, hk = x.clone(), h.clone()
    before = _build.launch_counts["h_update_covered"]
    uplink.h_update(xk, hk, x_bar, slot, band, M, S, 0.37, down=down_t,
                    covered=covered)
    assert _build.launch_counts["h_update_covered"] == before + 1
    ref.h_update(x, h, x_bar, slot, band, M, S, 0.37, down=down_t,
                 covered=covered)
    torch.cuda.synchronize()
    assert torch.equal(hk, h)
    assert _same(xk, x)


# h_update at every row count it is built around, at widths with every
# remainder mod 4 it handles apart, and on a workspace whose rows start off
# the 16-byte grid: idle NaN rows, a row that downloads without owning,
# bands outside [0, m) (the general modulo), and four gates
_HU_SLOTS = {1: [0], 4: [2, -1, 0, 3], 5: [2, -1, 0, 3, 1],
             8: [2, -1, 0, 3, 1, -1, -1, 0]}
_HU_DOWN = {1: [1], 4: [1, 1, 0, 0], 5: [1, 1, 0, 0, 1],
            8: [1, 1, 0, 0, 1, 0, 1, 1]}


@pytest.mark.parametrize("gate", ["none", "random", "all_off", "all_on"])
@pytest.mark.parametrize("rem", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 4, 5, 8])
def test_h_update_kernel_bitwise_at_every_width_and_alignment(dev, n, rem,
                                                              gate):
    d = 3 * 4096 + rem
    rng = np.random.default_rng(100 * n + rem)
    slot = np.array(_HU_SLOTS[n], np.int32)
    x0 = rng.normal(size=(n, d)).astype(np.float32)
    x0[slot < 0] = np.nan
    h0 = rng.normal(size=(n, d)).astype(np.float32)
    band = rng.integers(0, M, size=d).astype(np.int32)
    band[::97] = -3
    band[5::89] = 7
    x_bar = rng.normal(size=d).astype(np.float32)
    covered = {"none": None, "random": rng.random(d) < 0.75,
               "all_off": np.zeros(d, bool), "all_on": np.ones(d, bool)}[gate]
    name = "h_update" if covered is None else "h_update_covered"
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    slot_t, band_t, xb_t = to(slot), to(band), to(x_bar)
    down_t = torch.tensor(_HU_DOWN[n], dtype=torch.int32, device=dev)
    cov_t = None if covered is None else to(covered)
    for offset in (0, 1):  # rows aligned to 16 bytes, then one float off
        bx = torch.empty(n * d + offset, device=dev)
        bh = torch.empty(n * d + offset, device=dev)
        xk = bx[offset:].view(n, d)
        hk = bh[offset:].view(n, d)
        xk.copy_(to(x0))
        hk.copy_(to(h0))
        xp, hp = to(x0), to(h0)
        before = _build.launch_counts[name]
        uplink.h_update(xk, hk, xb_t, slot_t, band_t, M, S, 0.37,
                        down=down_t, covered=cov_t)
        assert _build.launch_counts[name] == before + 1
        ref.h_update(xp, hp, xb_t, slot_t, band_t, M, S, 0.37, down=down_t,
                     covered=cov_t)
        torch.cuda.synchronize()
        assert torch.equal(hk, hp), offset
        assert _same(xk, xp), offset
        if gate == "all_off":
            assert torch.equal(hk, to(h0)) and _same(xk, to(x0))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x, _, band, slot = _inputs(dev)
    with pytest.raises(ValueError):
        uplink.masked_sum(x.double(), slot, band, M, S)
    with pytest.raises(ValueError):
        uplink.masked_sum(x, slot.cpu(), band, M, S)
    with pytest.raises(ValueError):
        fused_local_step(x.t(), x.t(), x.t(), 0.1)
    # s > 16 is taken by the shared-memory kernel; s > m is not
    with pytest.raises(ValueError):
        uplink.robust_sum(x, slot, band, M, M + 1, kind="median")
    with pytest.raises(ValueError):
        uplink.robust_sum(x, slot, band, M, S, kind="trimmed", k=1)


def _lo(dims):
    """A kind group's leaf starts as host integers (the wrapper's form)."""
    return tuple(np.concatenate([[0], np.cumsum(dims)]).tolist())


@pytest.mark.parametrize("counts", [False, True])
def test_masked_sum_dequant_kernel_matches_plain(dev, counts):
    _, _, band, slot = _inputs(dev, 4)
    dims = (4097, 30, D - 4127)
    rng = np.random.default_rng(4)
    codes = torch.from_numpy(rng.integers(-127, 128, size=(N, D)).astype(
        np.int8)).to(dev)
    nc = sum(-(-d // 256) for d in dims)
    scales = torch.from_numpy(rng.random(size=(N, nc)).astype(
        np.float32)).to(dev)
    scales[1] = float("nan")  # the idle row: must not leak
    scales[0, 3] = float("nan")  # a poisoned chunk of an owned row
    lo = _lo(dims)
    name = "masked_sum_dequant_counts" if counts else "masked_sum_dequant"
    before = _build.launch_counts[name]
    got = uplink.masked_sum_dequant(codes, scales, lo, slot, band, M, S,
                                    counts=counts)
    assert _build.launch_counts[name] == before + 1
    want = ref.masked_sum_dequant(
        codes, scales, torch.tensor(lo, device=dev), slot, band, M, S,
        counts=counts)
    torch.cuda.synchronize()
    if not counts:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert 0 < int(got[0].isnan().sum()) < 256


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_wire_quantize_kernel_matches_plain(dev, kind):
    from repro_torch.kernels import wire_pack

    rng = np.random.default_rng(6)
    dims = (300, 13, 1030, 512)
    offs = np.concatenate([[0], np.cumsum(dims)]).tolist()
    x = torch.from_numpy((rng.normal(size=(N, offs[-1]))
                          * 3).astype(np.float32)).to(dev)
    x[1] = float("nan")  # an idle row is quantized too
    x[0, 5] = float("inf")
    x[2, 1300] = float("-inf")
    x[3, 313:569] = 0.0  # an all-zero chunk
    x[0, 400:] = -0.0
    leaves = [(0, offs[0], 300), (2, offs[2], 1030), (3, offs[3], 512)]
    before = _build.launch_counts["wire_quantize"]
    codes, scales = wire_pack.pack_int(x, leaves, kind, 0xDEADBEEF)
    assert _build.launch_counts["wire_quantize"] == before + 1
    codes_p, scales_p = ref.wire_pack(x, leaves, kind, 0xDEADBEEF)
    torch.cuda.synchronize()
    assert torch.equal(codes, codes_p)
    assert _same(scales, scales_p)
    assert torch.equal(scales.view(torch.int32), scales_p.view(torch.int32))
    row = x[2].clone()
    row[7] = float("nan")
    got, want = row.clone(), row.clone()
    wire_pack.quantize_down(got, leaves, kind, 12345)
    assert _build.launch_counts["wire_quantize"] == before + 2
    ref.wire_down(want, leaves, kind, 12345)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# The int wire's kernels at their edges: leaves whose sizes and offsets
# are not multiples of 4, 8, 16 or 256 (a leaf of one coordinate among
# them), rows off the 16-byte grid (an odd row width), ragged last chunks,
# an all-zero chunk, +-inf, NaN and -0.0 inputs, idle rows of NaN; and the
# same at widths where every chunk and run takes the 16-byte path.
_WQ_DIMS = {"ragged": (300, 13, 1, 1030, 511, 258),
            "aligned": (256, 1024, 512, 2048)}


@pytest.mark.parametrize("layout", ["ragged", "aligned"])
@pytest.mark.parametrize("n", [1, 4, 5])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_wire_quantize_kernel_bitwise_at_its_edges(dev, kind, n, layout):
    from repro_torch.kernels import wire_pack

    dims = _WQ_DIMS[layout]
    offs = np.concatenate([[0], np.cumsum(dims)]).tolist()
    rng = np.random.default_rng(len(dims) * 10 + n)
    x = torch.from_numpy((rng.normal(size=(n, offs[-1])) * 3).astype(
        np.float32)).to(dev)
    if n > 1:
        x[1] = float("nan")  # an idle row is quantized too
    x[0, 5] = float("inf")
    x[-1, 310] = float("-inf")
    x[0, 400] = float("nan")
    x[-1, offs[3]:offs[3] + 256] = 0.0  # an all-zero chunk
    x[:, 1000:1600] = torch.where(x[:, 1000:1600] > 1.0, -0.0,
                                  x[:, 1000:1600])
    # every leaf but the second, in another order than the row's
    leaves = [(i, offs[i], dims[i]) for i in range(len(dims)) if i != 1]
    leaves = leaves[1:] + leaves[:1]
    before = _build.launch_counts["wire_quantize"]
    codes, scales = wire_pack.pack_int(x, leaves, kind, 0xC0FFEE)
    assert _build.launch_counts["wire_quantize"] == before + 1
    codes_p, scales_p = ref.wire_pack(x, leaves, kind, 0xC0FFEE)
    torch.cuda.synchronize()
    assert torch.equal(codes, codes_p)
    assert torch.equal(scales.view(torch.int32), scales_p.view(torch.int32))
    assert bool(scales.isnan().any())
    # the DownCom in place on a row that starts off the 16-byte grid
    buf = torch.empty(offs[-1] + 1, device=dev)
    got = buf[1:]
    got.copy_(x[0])
    want = x[0].clone()
    wire_pack.quantize_down(got, leaves, kind, 0xC0FFEE)
    wire_pack.quantize_down(x[-1], leaves, kind, 12345)  # aligned, in place
    ref.wire_down(want, leaves, kind, 0xC0FFEE)
    assert _build.launch_counts["wire_quantize"] == before + 3
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    want_last = x[-1].clone()
    ref.wire_down(want_last, leaves, kind, 12345)  # quantizing is idempotent
    assert torch.equal(x[-1].view(torch.int32), want_last.view(torch.int32))


# group leaf starts one coordinate either side of multiples of 16, a leaf
# of one coordinate and ragged chunks; "offgrid": d % 4 != 0, so rows
# leave the 16-byte grid and every column takes the scalar path; "mixed":
# d % 4 == 0, so the 512-column warp blocks inside a leaf that starts on
# the 4-column grid take the 16-byte path beside scalar ones (and bands
# outside [0, m) send some of them back); "aligned": most blocks on the
# 16-byte path
_DQ_DIMS = {"offgrid": (15, 17, 1, 31, 16, 255, 257, 4096, 333),
            "mixed": (15, 17, 1, 31, 16, 255, 257, 4096, 336),
            "aligned": (256, 4096, 512, 1024)}
_DQ_SLOTS = {1: [1], 4: [2, -1, 0, 3], 5: [2, -1, 0, 3, 1]}


@pytest.mark.parametrize("layout", ["offgrid", "mixed", "aligned"])
@pytest.mark.parametrize("n", [1, 4, 5])
@pytest.mark.parametrize("counts", [False, True])
def test_masked_sum_dequant_kernel_bitwise_at_its_edges(dev, counts, n,
                                                        layout):
    from repro_torch.kernels import compress

    dims = _DQ_DIMS[layout]
    d = sum(dims)
    lo = _lo(dims)
    nc = sum(-(-D // 256) for D in dims)
    rng = np.random.default_rng(n * 7 + len(dims))
    slot = torch.tensor(_DQ_SLOTS[n], dtype=torch.int32, device=dev)
    band = rng.integers(0, M, size=d).astype(np.int32)
    if layout == "mixed":  # bands outside [0, m): the general modulo
        band[::97] = -3
        band[5::89] = M + 3
    band = torch.from_numpy(band).to(dev)
    codes = torch.from_numpy(rng.integers(-127, 128, size=(n, d)).astype(
        np.int8)).to(dev)
    codes[:, ::11] = 0  # +0 products, some of them against -0 scales
    scales = torch.from_numpy(rng.random(size=(n, nc)).astype(
        np.float32)).to(dev)
    scales[:, ::5] = -0.0
    for i, sl in enumerate(_DQ_SLOTS[n]):
        if sl < 0:
            scales[i] = float("nan")  # idle rows: must not leak
    # a poisoned chunk of an active row: NaN where it owns, nowhere else
    poisoned = nc - 3
    scales[0, poisoned] = float("nan")
    name = "masked_sum_dequant_counts" if counts else "masked_sum_dequant"
    before = _build.launch_counts[name]
    got = uplink.masked_sum_dequant(codes, scales, lo, slot, band, M, S,
                                    counts=counts)
    assert _build.launch_counts[name] == before + 1
    want = ref.masked_sum_dequant(
        codes, scales, torch.tensor(lo, device=dev), slot, band, M, S,
        counts=counts)
    torch.cuda.synchronize()
    if not counts:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    chunk = compress.chunk_cols(torch.tensor(lo, device=dev), 0, d)
    owned0 = (_DQ_SLOTS[n][0] + band.long()) % M < S
    assert torch.equal(got[0].isnan(), owned0 & (chunk == poisoned))


@pytest.mark.parametrize("policy", ["int8", "auto"])
def test_wire_comm_step_makes_no_host_sync_on_the_card(dev, policy):
    """One wire comm step (the UpCom over the int wire, ``wire_down``) with
    PyTorch's sync debugging set to raise: the wrappers read nothing back
    from the card.  The step then agrees bitwise with the CPU's."""
    from repro_torch.dist import comm_ws

    rng = np.random.default_rng(9)
    dims = (300, 70001, 50, 3, 4096)
    n, c, s = 4, 3, 2
    x = rng.normal(size=(n, sum(dims))).astype(np.float32)
    h = 0.01 * rng.normal(size=(n, sum(dims))).astype(np.float32)
    x[1] = np.nan  # idle
    slot = np.array([1, -1, 0, 2], np.int32)
    down = np.array([1, 0, 1, 1], np.int32)
    out = {}
    for d in ("cpu", dev):
        band = comm_ws.cyclic_band(dims, c, s, d)
        plan = comm_ws.wire_plan(dims, policy, c, s, band)
        xw, hw = torch.tensor(x, device=d), torch.tensor(h, device=d)
        slot_t = torch.from_numpy(slot).to(d)
        down_t = torch.from_numpy(down).to(d)
        if d == dev:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            x_bar = comm_ws.cyclic_comm(xw, hw, slot_t, band, c, s, 0.37,
                                        down=down_t, wire=plan,
                                        wire_seed=0xBEEF, wire_down=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[str(d)] = (x_bar.cpu(), xw.cpu(), hw.cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert _same(a, b)


@pytest.mark.parametrize("step", ["f32", "survivor", "robust",
                                  "robust_survivor"])
def test_comm_step_makes_no_host_sync_on_the_card(dev, step):
    """The f32, survivor and robust comm steps (``cyclic_comm`` without a
    wire) with PyTorch's sync debugging set to raise: the wrappers read
    nothing back from the card.  The step then agrees bitwise with the
    CPU's."""
    from repro_torch.dist import comm_ws

    rng = np.random.default_rng(11)
    dims = (300, 70001, 50, 3, 4096)
    n, c, s = 5, 4, 3
    x = rng.normal(size=(n, sum(dims))).astype(np.float32)
    h = 0.01 * rng.normal(size=(n, sum(dims))).astype(np.float32)
    x[4] = np.nan  # idle
    slot = np.array([1, 0, 3, 2, -1], np.int32)
    down = np.array([1, 1, 0, 1, 1], np.int32)
    arrived = (np.array([True, True, False, True, True])
               if step in ("survivor", "robust_survivor") else None)
    if arrived is not None:
        x[2] = np.nan  # the dropped row
    robust = ("trimmed", 1) if step.startswith("robust") else None
    out = {}
    for d in ("cpu", dev):
        band = comm_ws.cyclic_band(dims, c, s, d)
        xw, hw = torch.tensor(x, device=d), torch.tensor(h, device=d)
        slot_t = torch.from_numpy(slot).to(d)
        down_t = torch.from_numpy(down).to(d)
        arr_t = None if arrived is None else torch.from_numpy(arrived).to(d)
        if d == dev:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            x_bar = comm_ws.cyclic_comm(xw, hw, slot_t, band, c, s, 0.37,
                                        down=down_t, arrived=arr_t,
                                        robust=robust)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[str(d)] = (x_bar.cpu(), xw.cpu(), hw.cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert _same(a, b)


@pytest.mark.parametrize("policy,wire_down,survivor", [
    ("auto", True, False), ("int8", False, True), ("bf16", True, True)])
def test_wire_comm_step_card_matches_cpu_bitwise(dev, policy, wire_down,
                                                 survivor):
    from repro_torch.dist import comm_ws

    rng = np.random.default_rng(7)
    dims = (300, 70001, 50, 3)
    n, c, s = 5, 4, 3
    x = rng.normal(size=(n, sum(dims))).astype(np.float32)
    h = 0.01 * rng.normal(size=(n, sum(dims))).astype(np.float32)
    x[4] = np.nan  # idle
    slot = np.array([1, 0, 3, 2, -1], np.int32)
    down = np.array([1, 1, 0, 1, 1], np.int32)
    arrived = np.array([True, True, False, True, True]) if survivor else None
    out = {}
    for d in ("cpu", dev):
        band = comm_ws.cyclic_band(dims, c, s, d)
        plan = comm_ws.wire_plan(dims, policy, c, s, band)
        # copies: the comm step works in place
        xw, hw = torch.tensor(x, device=d), torch.tensor(h, device=d)
        comm_ws.cyclic_comm(
            xw, hw, torch.from_numpy(slot).to(d), band, c, s, 0.37,
            down=torch.from_numpy(down).to(d),
            arrived=None if arrived is None else torch.from_numpy(
                arrived).to(d),
            wire=plan, wire_seed=77, wire_down=wire_down)
        out[str(d)] = (xw.cpu(), hw.cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert _same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rank", [1, 2])
def test_compress_kernel_matches_plain(dev, dtype, rank):
    from repro_torch.kernels import compress

    c, s = 7, 3
    g = torch.Generator(device=dev).manual_seed(5)
    if rank == 2:
        x = torch.randn(6, 3 * 4096 + 77, generator=g, device=dev,
                        dtype=dtype)
        slot = torch.tensor([0, 3, 6, 7, -1, 2], dtype=torch.int32,
                            device=dev)
    else:
        x = torch.randn(3 * 4096 + 77, generator=g, device=dev, dtype=dtype)
        slot = torch.tensor([4], dtype=torch.int32, device=dev)
    x.view(-1)[5::97] = float("nan")  # unowned NaN must not leak
    name = (f"compress{'_1d' if rank == 1 else ''}_"
            f"{'f64' if dtype == torch.float64 else 'f32'}")
    before = _build.launch_counts[name]
    got = compress.compress(x, slot, c, s)
    assert _build.launch_counts[name] == before + 1
    want = ref.compress(x, slot, c, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [
    # (n, d, c, s, storage offset in elements, slots)
    (5, 3 * 4096 + 77, 7, 3, 1, [0, 3, 6, 7, -1]),  # d % 4 != 0, off grid
    (3, 1023, 5, 2, 3, [4, 0, 2]),        # every row's start off the grid
    (4, 5, 9, 2, 0, [0, 8, 3, -2]),       # c > d
    (4, 2049, 6, 6, 1, [5, 0, 9, -1]),    # s = c
    (3, 4096, 4, 2, 0, [-5, 4, 100]),     # every slot outside [0, c)
    (1, 20958, 100, 2, 1, [37]),          # n = 1, off grid
])
def test_compress_kernel_bitwise_at_its_edges(dev, dtype, case):
    from repro_torch.kernels import compress

    n, d, c, s, off, slots = case
    g = torch.Generator(device=dev).manual_seed(n * d + c)
    buf = torch.randn(n * d + off, generator=g, device=dev, dtype=dtype)
    buf[::5] = float("nan")  # unowned NaN and inf must not leak
    buf[2::7] = float("inf")
    buf[3::11] = -0.0
    x = buf[off:].view(n, d)  # contiguous, starting off the 16-byte grid
    slot = torch.tensor(slots, dtype=torch.int32, device=dev)
    for xs, sl in ((x, slot), (x[0], slot[:1])):  # both ranks
        got = compress.compress(xs, sl, c, s)
        want = ref.compress(xs, sl, c, s)
        torch.cuda.synchronize()
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits))


def test_convex_rounds_on_the_card_match_the_cpu(dev):
    from repro_torch.core import problems, tamuna

    prob = problems.make_logreg_problem(n=40, d=300, samples_per_client=4,
                                        kappa=100.0, device="cpu")
    cfg = tamuna.TamunaConfig.tuned(prob, c=10)
    out = {}
    for d in ("cpu", dev):
        _build.reset_launch_counts()
        out[str(d)] = tamuna.run(prob.to(d), cfg, 5, record_every=5)
        launches = _build.launch_counts["compress_f64"]
        assert launches == (0 if d == "cpu" else 10)
    a, b = out["cpu"]["state"], out[str(dev)]["state"]
    for x, y in ((a.x_bar, b.x_bar), (a.h, b.h)):
        assert float((x - y.cpu()).abs().max()) <= 1e-10 * float(
            x.abs().max())
    assert a.total_local_steps == b.total_local_steps


def _bf16_ulps(a, b):
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -10)
    return float(((a - b).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                             - 7)).max())


@pytest.mark.parametrize("qt,kvt,name", [
    (torch.bfloat16, torch.bfloat16, "decode_attention"),
    (torch.float32, torch.float32, "decode_attention_f32"),
    (torch.float32, torch.bfloat16, "decode_attention_f32_bf16kv"),
])
@pytest.mark.parametrize("b,h,kvh,hd,S", [
    (2, 8, 4, 256, 1500), (3, 6, 6, 32, 300), (1, 8, 1, 64, 700),
    (2, 7, 1, 128, 520), (2, 8, 2, 64, 4097),
    (2, 32, 32, 80, 600), (2, 8, 2, 80, 1100),  # hd 80: stablelm-3b
])
def test_decode_attention_kernel_matches_plain(dev, qt, kvt, name, b, h, kvh,
                                               hd, S):
    """The decode kernel against its plain version: bf16 outputs within
    one bf16 ulp, f32 within 2e-5 (the online softmax adds in another
    order), across head dims, GQA groups 1-8, windows and softcaps."""
    from repro_torch.kernels import decode_attn

    g = torch.Generator(device=dev).manual_seed(b * h + S)
    q = torch.randn(b, h, hd, generator=g, device=dev).to(qt)
    k = torch.randn(b, S, kvh, hd, generator=g, device=dev).to(kvt)
    v = torch.randn(b, S, kvh, hd, generator=g, device=dev).to(kvt)
    for pos in (0, S // 3, S - 1):
        for window, cap in ((None, None), (16, 50.0), (S, 30.0)):
            before = _build.launch_counts[name]
            got = decode_attn.decode_attention(q, k, v, pos, window=window,
                                               softcap=cap)
            assert _build.launch_counts[name] == before + 1
            want = ref.decode_attention(q, k, v, pos, window=window,
                                        softcap=cap)
            torch.cuda.synchronize()
            assert got.dtype == qt
            if qt == torch.bfloat16:
                assert _bf16_ulps(got, want) <= 1.0, (pos, window)
            else:
                assert float((got - want).abs().max()) < 2e-5, (pos, window)


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_decode_attention_bf16_kernel_at_tile_and_split_edges(dev, group,
                                                              hd):
    """The bf16 kernel (16-key tiles, split runs a multiple of 16) with
    ``pos`` at the first tile's edges, at a split's length and at the
    cache's end, globally and in a window whose start is off the tile
    grid: within one bf16 ulp of the plain version."""
    from repro_torch.kernels import decode_attn

    b, kvh, S = 2, 2, 1200
    h = kvh * group
    g = torch.Generator(device=dev).manual_seed(group * hd)
    q = torch.randn(b, h, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(b, S, kvh, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(b, S, kvh, hd, generator=g, device=dev).bfloat16()
    _, split_len = decode_attn.split_plan(b, kvh, S, tiled=True)
    assert split_len % decode_attn.TILE == 0
    tile = decode_attn.TILE
    for pos in (0, tile - 1, tile, split_len, S - 1):
        for window in (None, 41):
            before = _build.launch_counts["decode_attention"]
            got = decode_attn.decode_attention(q, k, v, pos, window=window,
                                               softcap=50.0)
            assert _build.launch_counts["decode_attention"] == before + 1
            want = ref.decode_attention(q, k, v, pos, window=window,
                                        softcap=50.0)
            torch.cuda.synchronize()
            assert _bf16_ulps(got, want) <= 1.0, (pos, window)


def test_decode_attention_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels import decode_attn

    q = torch.zeros(1, 4, 96, device=dev)  # no config has head_dim 96
    k = torch.zeros(1, 8, 2, 96, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attn.decode_attention(q, k, k, 3)
    q = torch.zeros(1, 4, 64, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, device=dev)
    with pytest.raises(ValueError, match="no kernel"):
        decode_attn.decode_attention(q, k, k, 3)
    with pytest.raises(ValueError, match="outside"):
        decode_attn.decode_attention(q, k.bfloat16(), k.bfloat16(), 8)


def test_decode_step_through_the_kernel_matches_plain(dev):
    """The reduced config served past its window on the card, through the
    kernel and through the model's plain attention, from the same
    weights: logits within 1e-5 of the largest, launches counted."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.dist import model_api
    from repro_torch.kernels.decode_attn import make_attend_fn

    cfg = gemma2_2b.REDUCED
    params = model_api.init(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 70),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    caches = [model_api.make_cache(cfg, 2, 70, torch.float32, dev)
              for _ in range(2)]
    _build.reset_launch_counts()
    with torch.no_grad():
        for i in range(70):
            lk, _ = model_api.decode(params, cfg, toks[:, i:i + 1],
                                     caches[0], i, make_attend_fn(cfg))
            lp, _ = model_api.decode(params, cfg, toks[:, i:i + 1],
                                     caches[1], i)
            assert float((lk - lp).abs().max()) <= 1e-5 * float(
                lp.abs().max()), i
    assert _build.launch_counts["decode_attention_f32"] == 70 * cfg.n_layers


# --------------------------------------------------------------------------
# the blocked template, the row pitch and AdamW on the card
# --------------------------------------------------------------------------

_BLOCK_DIMS = (300, 70001, 50, 3, 4097)  # ragged last blocks; 3 < c


@pytest.mark.parametrize("step", ["f32", "survivor", "trimmed", "median",
                                  "int8", "auto_survivor"])
def test_blocked_comm_step_card_matches_cpu_bitwise(dev, step):
    """The blocked template's kernel path (``comm_ws.blocked_comm``: the
    block band ``k // ceil(D / c)`` with band values up to ``c - 1`` and a
    ragged last block per leaf) on the card against the CPU: every kernel
    of the path with that band, bitwise, each launched."""
    from repro_torch.dist import comm_ws

    rng = np.random.default_rng(21)
    dims = _BLOCK_DIMS
    n, c, s = 6, 5, 3
    x = rng.normal(size=(n, sum(dims))).astype(np.float32)
    h = 0.01 * rng.normal(size=(n, sum(dims))).astype(np.float32)
    x[5] = np.nan  # idle
    slot_of = np.array([3, 0, 4, 1, 2, -1], np.int32)
    down = np.array([1, 1, 0, 1, 1, 1], np.int32)
    survivor = step in ("survivor", "trimmed", "int8", "auto_survivor")
    arrived = (np.array([True, True, False, True, True, True])
               if survivor else None)
    if survivor:
        x[2] = np.nan  # the dropped row
    robust = {"trimmed": ("trimmed", 1), "median": ("median", 0)}.get(step)
    policy = {"int8": "int8", "auto_survivor": "auto"}.get(step)
    need = {"f32": "h_update", "survivor": "masked_sum_counts",
            "trimmed": "robust_sum", "median": "robust_sum",
            "int8": "masked_sum_dequant_counts",
            "auto_survivor": "masked_sum_counts_f16"}[step]
    out = {}
    for d in ("cpu", dev):
        band = comm_ws.block_band(dims, c, d)
        assert int(band.max()) == c - 1
        plan = comm_ws.wire_plan(dims, policy, c, s, band,
                                 template="blocked")
        xw, hw = torch.tensor(x, device=d), torch.tensor(h, device=d)
        before = _build.launch_counts[need]
        x_bar = comm_ws.blocked_comm(
            xw, hw, 3, torch.from_numpy(slot_of).to(d), band, c, s, 0.37,
            down=torch.from_numpy(down).to(d),
            arrived=None if arrived is None else torch.from_numpy(
                arrived).to(d),
            robust=robust, wire=plan, wire_seed=99, wire_down=bool(policy))
        if d == dev:
            assert _build.launch_counts[need] > before
        out[str(d)] = (x_bar.cpu(), xw.cpu(), hw.cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert _same(a, b)


@pytest.mark.parametrize("extra", [4, 7])
@pytest.mark.parametrize("kernel", ["masked_sum", "masked_sum_counts",
                                    "masked_sum_f16", "robust_sum",
                                    "h_update", "h_update_covered"])
def test_workspace_kernels_take_a_row_pitch(dev, kernel, extra):
    """The workspace kernels over the first d columns of an (n, d + extra)
    workspace (the tall-and-thin layout): bitwise with the plain version on
    the same view, on the 16-byte vector path (pitch a multiple of 4) and
    off it, and the columns past d untouched."""
    n, d = 5, 3 * 4096 + 77
    rng = np.random.default_rng(31 + extra)
    wide = rng.normal(size=(n, d + extra)).astype(np.float32)
    wide[1] = np.nan
    slot = torch.tensor([2, -1, 0, 3, 1], dtype=torch.int32, device=dev)
    band = torch.from_numpy(rng.integers(0, M, size=d).astype(
        np.int32)).to(dev)
    lane = torch.float16 if kernel == "masked_sum_f16" else torch.float32
    ws = torch.from_numpy(wide).to(dev).to(lane)
    hs = torch.from_numpy(rng.normal(size=(n, d + extra)).astype(
        np.float32)).to(dev)
    x, h = ws[:, :d], hs[:, :d]
    assert not x.is_contiguous() and x.stride(0) == d + extra
    before = _build.launch_counts[kernel]
    if kernel.startswith("masked_sum"):
        counts = kernel == "masked_sum_counts"
        got = uplink.masked_sum(x, slot, band, M, S, counts=counts)
        want = (ref.masked_sum_counts(x, slot, band, M, S) if counts
                else ref.masked_sum(x, slot, band, M, S))
        pairs = list(zip(got, want)) if counts else [(got, want)]
    elif kernel == "robust_sum":
        pairs = list(zip(uplink.robust_sum(x, slot, band, M, 3,
                                           kind="trimmed", k=1),
                         ref.robust_sum(x, slot, band, M, 3, "trimmed", 1)))
    else:
        cov = (torch.from_numpy(rng.random(d) < 0.7).to(dev)
               if kernel == "h_update_covered" else None)
        x_bar = torch.from_numpy(rng.normal(size=d).astype(np.float32)
                                 ).to(dev)
        down = torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32, device=dev)
        ws2, hs2 = ws.clone(), hs.clone()
        uplink.h_update(x, h, x_bar, slot, band, M, S, 0.37, down=down,
                        covered=cov)
        ref.h_update(ws2[:, :d], hs2[:, :d], x_bar, slot, band, M, S, 0.37,
                     down=down, covered=cov)
        pairs = [(ws, ws2), (hs, hs2)]
    torch.cuda.synchronize()
    assert _build.launch_counts[kernel] == before + 1
    for g, w in pairs:
        assert _same(g.float(), w.float())
    assert _same(ws[:, d:].float(), torch.from_numpy(wide[:, d:]).to(
        dev).to(lane).float())


def test_tall_leaves_comm_step_card_matches_cpu_bitwise(dev):
    """A workspace with two wide leaves (the kernels) and two tall leaves
    laid after them (the dense fallback), int8 wire, a drop: the card
    against the CPU, bitwise; the kernels take only the wide columns."""
    from repro_torch.dist import comm_ws

    rng = np.random.default_rng(41)
    n = c = 40
    s = 2
    dims = (4096 + 3, 777, 16, 16)  # the last two: D s = 32 < c
    x = rng.normal(size=(n, sum(dims))).astype(np.float32)
    h = 0.01 * rng.normal(size=(n, sum(dims))).astype(np.float32)
    slot = rng.permutation(c).astype(np.int32)
    down = (rng.random(n) < 0.7).astype(np.int32)
    arrived = rng.random(n) < 0.9
    d_main = dims[0] + dims[1]
    tall = ((2, d_main, 16, "f16"), (3, d_main + 16, 16, "f16"))
    out = {}
    for d in ("cpu", dev):
        band = comm_ws.cyclic_band(dims[:2], c, s, d)
        plan = comm_ws.wire_plan(dims[:2], "auto", c, s, band)
        xw, hw = torch.tensor(x, device=d), torch.tensor(h, device=d)
        comm_ws.cyclic_comm(
            xw, hw, torch.from_numpy(slot).to(d), band, c, s, 0.37,
            down=torch.from_numpy(down).to(d),
            arrived=torch.from_numpy(arrived).to(d), wire=plan,
            wire_seed=5, wire_down=True, tall=tall)
        out[str(d)] = (xw.cpu(), hw.cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert _same(a, b)


def test_adamw_leaf_on_the_card_matches_cpu_bitwise(dev):
    """The AdamW update (plain torch, in chunks) on the card against the
    CPU: CUDA's f32 sqrt and division are correctly rounded, as the CPU's
    f64 square root rounded once is."""
    from repro_torch.optim import optimizers

    rng = np.random.default_rng(51)
    arrs = [rng.normal(size=(3, 70001)).astype(np.float32) for _ in range(2)]
    out = {}
    for d in ("cpu", dev):
        p = torch.tensor(arrs[0], device=d)  # a copy: updated in place
        state = optimizers.adamw(0.05, weight_decay=0.01).init(p)
        opt = optimizers.adamw(0.05, weight_decay=0.01)
        for t in range(3):
            g = torch.from_numpy(arrs[1] * (t + 0.5)).to(d)
            p, state = opt.update(g, state, p)
        out[str(d)] = (p.cpu(), state.mu.cpu(), state.nu.cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(a, b)


def test_pipelined_rounds_on_the_card_match_the_cpu(dev):
    """Three staleness-1 rounds under a quorum of 2 with a latency model
    (a 1-layer width-16 model, n=6, c=3, s=2, the same batches on both
    devices) on the card against the CPU: the same schedule, admissions,
    uncovered counts and clock; x and h within 1e-5, h moved off zero by
    the survivor h update; the survivor kernels launched."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.dist import faults, rounds, tamuna_dp

    cfg = dataclasses.replace(
        registry.get_reduced_config("gemma2-2b"), n_layers=1, d_model=16,
        n_heads=2, n_kv_heads=1, head_dim=8, d_ff=32, vocab=64)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.5)
    toks = np.random.default_rng(4).integers(0, 64, size=(12, 3, 1, 9))

    class Pipe:
        def __init__(self, d):
            self.d, self.used = d, 0
            self.generator = torch.Generator()

        def sample_batch(self, clients):
            tk = torch.from_numpy(toks[self.used]).to(self.d)
            self.used += 1
            return {"tokens": tk[..., :-1], "labels": tk[..., 1:]}

    out = {}
    for d in ("cpu", dev):
        # the same initial state on both devices: drawn on the CPU
        state = tamuna_dp.init_state(cfg, tcfg, 6, seed=0, device="cpu")
        state.x, state.h = state.x.to(d), state.h.to(d)
        engine = rounds.make_pipelined_round_fn(cfg, tcfg, 6, pipe=Pipe(d),
                                                max_L=2, device=d)
        _build.reset_launch_counts()
        state, rows = rounds.run_rounds_pipelined(
            state, round_fn=engine, rounds=3, rng=np.random.default_rng(3),
            generator=torch.Generator().manual_seed(1), p=0.5, staleness=1,
            latency=faults.EmpiricalDelays([0.05, 0.1, 3.0], n=6, seed=5),
            policy="quorum", quorum=2)
        out[str(d)] = (state.x.cpu(), state.h.cpu(), rows,
                       dict(_build.launch_counts))
    (xc, hc, rc, _), (xg, hg, rg, launches) = out["cpu"], out[str(dev)]
    keys = ("L", "admitted", "late_dropped", "uncovered", "dispatch_s",
            "commit_s", "up_floats")
    assert [[r[k] for k in keys] for r in rc] == \
        [[r[k] for k in keys] for r in rg]
    assert (xc - xg).abs().max() <= 1e-5 and (hc - hg).abs().max() <= 1e-5
    assert hc.abs().max() > 0
    for k in ("masked_sum_counts", "h_update_covered", "fused_local_step"):
        assert launches[k] > 0, launches


# --------------------------------------------------------------------------
# the MoE, RWKV-6 and Mamba2-hybrid families on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                                  "rwkv6-7b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_family_round_on_the_card_matches_the_cpu(dev, arch):
    """One TAMUNA round of each new family's reduced config (n=4, c=3,
    s=2, two local steps of 32 tokens, the same state, batches, frames for
    the encoder-decoder, and schedule) on the card, on the CPU and on the
    CPU in float64 compute:
    leaf by leaf in x and in h, the card no farther from the float64
    round than 4x the CPU's distance for that leaf, or 1e-5 where that is
    larger (these families' f32 rounds lie 2e-5 to 1e-4 from it, and the
    card's products accumulate in other orders:
    ``chip_smoke.check_reduced_family_round``), the round's kernels
    launched."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.dist import tamuna_dp

    cfg = registry.get_reduced_config(arch)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 3, 2, 33)))
    frames = (torch.from_numpy(rng.normal(size=(
        2, 3, 2, cfg.n_frames, cfg.d_model)).astype(np.float32))
        if cfg.family == "encdec" else None)
    out, noise = {}, None
    for tag, d, dt in (("cpu", "cpu", None), ("card", dev, None),
                       ("f64", "cpu", torch.float64)):
        c = cfg if dt is None else dataclasses.replace(cfg, dtype=dt)
        state = tamuna_dp.init_state(c, tcfg, 4, seed=0, device="cpu")
        if noise is None:  # the other rows made distinct, on every side
            noise = torch.from_numpy((0.01 * rng.normal(
                size=tuple(state.x[1:].shape))).astype(np.float32))
        state.x[1:] += noise
        state.x, state.h = state.x.to(d), state.h.to(d)
        local = tamuna_dp.make_local_step(c, tcfg)
        compact = tamuna_dp.gather_cohort(state, [0, 2, 3])
        _build.reset_launch_counts()
        for t in range(2):
            tk = toks[t].to(d)
            kw = {} if frames is None else {"frames": frames[t].to(d)}
            local(compact, tokens=tk[..., :-1], labels=tk[..., 1:], **kw)
        comm = tamuna_dp.make_comm_step(c, tcfg, 4, device=d)
        state = comm(tamuna_dp.scatter_cohort(state, compact), [0, 2, 3],
                     [2, 0, 1], torch.tensor([True, True, False, True]))
        out[tag] = (state.x.cpu(), state.h.cpu(),
                    dict(_build.launch_counts))

    spec = tamuna_dp.state_spec(cfg, tcfg)
    for i in (0, 1):
        for name, off, d in zip(spec.names, spec.offsets, spec.dims):
            cpu_l, card_l = (float((out[a][i][:, off:off + d]
                                    - out["f64"][i][:, off:off + d])
                                   .abs().max()) for a in ("cpu", "card"))
            assert card_l <= max(1e-5, 4 * cpu_l), (i, name, card_l, cpu_l)
    for k in ("masked_sum", "h_update", "fused_local_step"):
        assert out["card"][2][k] > 0, out["card"][2]


def test_decode_attention_hd128_group1_matches_plain(dev):
    """The bf16 kernel at qwen2-moe-a2.7b's serving shape (16 heads of
    128, group 1) over a 4096-key cache, and at qwen3-moe's group 8,
    within one bf16 ulp of the plain version."""
    from repro_torch.kernels import decode_attn

    g = torch.Generator(device=dev).manual_seed(128)
    for b, h, kvh in ((8, 16, 16), (8, 32, 4)):
        q = torch.randn(b, h, 128, generator=g, device=dev).bfloat16()
        k = torch.randn(b, 4096, kvh, 128, generator=g, device=dev).bfloat16()
        v = torch.randn(b, 4096, kvh, 128, generator=g, device=dev).bfloat16()
        for pos, window in ((4095, None), (4095, 1024), (15, None),
                            (2047, 41)):
            got = decode_attn.decode_attention(q, k, v, pos, window=window)
            want = ref.decode_attention(q, k, v, pos, window=window)
            torch.cuda.synchronize()
            assert _bf16_ulps(got, want) <= 1.0, (h, kvh, pos, window)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-2.7b",
                                  "rwkv6-7b"])
def test_family_decode_through_the_kernel_matches_plain(dev, arch):
    """Each new family's reduced config decoded on the card for 40 steps
    through the kernel and through the model's plain attention, from the
    same weights: logits within 1e-5 of the largest, the kernel launched
    once per attention per step (none for RWKV-6)."""
    from repro_torch.configs import registry
    from repro_torch.dist import model_api
    from repro_torch.kernels.decode_attn import make_attend_fn

    cfg = registry.get_reduced_config(arch)
    params = model_api.init(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    caches = [model_api.make_cache(cfg, 2, 40, torch.float32, dev)
              for _ in range(2)]
    _build.reset_launch_counts()
    with torch.no_grad():
        for i in range(40):
            lk, _ = model_api.decode(params, cfg, toks[:, i:i + 1],
                                     caches[0], i, make_attend_fn(cfg))
            lp, _ = model_api.decode(params, cfg, toks[:, i:i + 1],
                                     caches[1], i)
            assert float((lk - lp).abs().max()) <= 1e-5 * float(
                lp.abs().max()), i
    assert _build.launch_counts["decode_attention_f32"] == 40 * cfg.n_attn


def test_whisper_serve_on_the_card_matches_the_cpu(dev):
    """whisper-tiny-reduced served through ``launch.serve.run`` (the frames
    encoded once into the cross K/V, 8 prompt tokens, 6 greedy ones) on
    an f32 cache, on the card and on the CPU from the same weights and
    frames: the greedy tokens equal, the last logits within 1e-4 of the
    largest, finite at every step, and no decode-attention launch (the
    encoder-decoder's decode takes no attend_fn)."""
    from repro_torch.configs import registry
    from repro_torch.dist import model_api
    from repro_torch.launch import serve

    cfg = registry.get_reduced_config("whisper-tiny")
    params = model_api.init(cfg, seed=0, device="cpu")
    prompts = serve.make_prompts(2, 8, cfg.vocab, 0, "cpu")
    frames = serve.make_frames(2, cfg, "cpu")
    out = {}
    for d in ("cpu", dev):
        _build.reset_launch_counts()
        with torch.no_grad():
            out[str(d)] = serve.run(
                {k: v.to(d) for k, v in params.items()}, cfg, prompts.to(d),
                6, kv_dtype=torch.float32, frames=frames.to(d))
        launches = {k: v for k, v in _build.launch_counts.items() if v}
    cpu, card = out["cpu"], out[str(dev)]
    assert card["finite"] and cpu["finite"]
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    err = (card["logits"].cpu() - cpu["logits"]).abs().max()
    assert float(err) <= 1e-4 * float(cpu["logits"].abs().max())
    assert launches == {}


# -- the kernels' whole domain: robust_sum past s = 16 (each column's
# owners in a shared-memory list) and h_update past 4096 rows (the rows that
# own or download listed, then walked in tiles); the sizes up to those keep
# the register and staged kernels

def _robust_edge(dev, s, layout, dup=False):
    """``_edge_inputs`` for the robust UpCom at sparsity ``s``: ``s + 2``
    template columns, a dropped and an idle row, ties, +-inf, +-0.0, an
    owned NaN, all-+inf columns; with ``dup`` one column owned by two
    rows, so some coordinates have more than s owners."""
    m = s + 2
    cols = np.random.default_rng(s).permutation(m)[:s].tolist()
    slots = [cols[0], -1] + cols[1:] + [-1] + ([cols[1]] if dup else [])
    x, slot, band = _edge_inputs(dev, len(slots), layout, m, slots, 40 + s)
    act = [i for i, v in enumerate(slot.tolist()) if 0 <= v < m]
    x[act[-1], ::7] = x[act[0], ::7]
    x[act[0], ::101] = float("inf")
    x[act[-1], 50::101] = float("-inf")
    x[act[-1], 9::57] = float("nan")
    x[act[0], 3::29] = 0.0
    x[act[-1], 3::29] = -0.0
    x[act, 11::211] = float("inf")
    return x, slot, band, m


@pytest.mark.parametrize("kind,k", [("trimmed", 0), ("trimmed", 3),
                                    ("trimmed", 8), ("median", 0)])
@pytest.mark.parametrize("s,layout,dup", [
    (17, "aligned", False), (17, "outside", False), (32, "aligned", False),
    (32, "offgrid", False), (17, "aligned", True)])
def test_robust_sum_past_16_is_bitwise_plain(dev, s, layout, dup, kind, k):
    x, slot, band, m = _robust_edge(dev, s, layout, dup)
    before = dict(_build.launch_counts)
    bar, cnt = uplink.robust_sum(x, slot, band, m, s, kind=kind, k=k)
    assert _build.launch_counts["robust_sum_large_s"] == \
        before["robust_sum_large_s"] + 1
    assert _build.launch_counts["robust_sum"] == before["robust_sum"]
    bar_p, cnt_p = ref.robust_sum(x, slot, band, m, s, kind, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(cnt), _bits(cnt_p))
    if dup:
        assert float(cnt.max()) > s
    nan = bar.isnan()
    assert torch.equal(nan, bar_p.isnan()) and bool(nan.any())
    assert torch.equal(_bits(bar.masked_fill(nan, 0.0)),
                       _bits(bar_p.masked_fill(nan, 0.0)))


def test_robust_sum_at_16_keeps_the_register_kernel(dev):
    x, slot, band, m = _robust_edge(dev, 16, "aligned")
    before = dict(_build.launch_counts)
    uplink.robust_sum(x, slot, band, m, 16, kind="median")
    assert _build.launch_counts["robust_sum"] == before["robust_sum"] + 1
    assert _build.launch_counts["robust_sum_large_s"] == \
        before["robust_sum_large_s"]


@pytest.mark.parametrize("covered", [False, True])
@pytest.mark.parametrize("n", [4096, 4097])
def test_h_update_past_4096_rows_is_bitwise_plain(dev, n, covered):
    """A population of 4097 rows (64 in the cohort, a quarter downloading)
    takes the unstaged kernel, 4096 the staged one; both bitwise."""
    d, m, s = 2 * 4096 + 77, 64, 2
    rng = np.random.default_rng(n)
    slot = np.full(n, -1, np.int32)
    members = rng.choice(n, m, replace=False)
    slot[members] = rng.permutation(m)
    down = (rng.random(n) < 0.25).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[slot < 0] = np.nan
    h = rng.normal(size=(n, d)).astype(np.float32)
    band = rng.integers(0, m, size=d).astype(np.int32)
    x, h, slot, down, band = (torch.from_numpy(a).to(dev) for a in
                              (x, h, slot, down, band))
    x_bar = torch.randn(d, device=dev)
    cov = torch.rand(d, device=dev) < 0.7 if covered else None
    name = "h_update_covered" if covered else "h_update"
    name += "_large_n" if n > 4096 else ""  # kHMaxRows staged rows
    xk, hk = x.clone(), h.clone()
    before = dict(_build.launch_counts)
    uplink.h_update(xk, hk, x_bar, slot, band, m, s, 0.37, down=down,
                    covered=cov)
    assert {k for k in _build.launch_counts
            if _build.launch_counts[k] != before[k]} == {name}
    ref.h_update(x, h, x_bar, slot, band, m, s, 0.37, down=down,
                 covered=cov)
    torch.cuda.synchronize()
    assert torch.equal(hk, h)
    assert _same(xk, x)


# -- the redesigned bodies past the staged limits: robust_sum's lists in
# shared memory (fewer columns per block as s grows, global memory past
# 32 threads' worth) and h_update's row list and tiles

def _robust_large(dev, x, slot, band, m, s, kind, k):
    before = dict(_build.launch_counts)
    bar, cnt = uplink.robust_sum(x, slot, band, m, s, kind=kind, k=k)
    assert {n for n in _build.launch_counts
            if _build.launch_counts[n] != before[n]} == {"robust_sum_large_s"}
    bar_p, cnt_p = ref.robust_sum(x, slot, band, m, s, kind, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(cnt), _bits(cnt_p))
    nan = bar.isnan()
    assert torch.equal(nan, bar_p.isnan())
    assert torch.equal(_bits(bar.masked_fill(nan, 0.0)),
                       _bits(bar_p.masked_fill(nan, 0.0)))
    return bar


@pytest.mark.parametrize("kind,k", [("trimmed", 2), ("median", 0)])
@pytest.mark.parametrize("s", [33, 64])
def test_robust_sum_large_s_is_bitwise_plain(dev, s, kind, k):
    """s = 33 and 64: the 64-value network in registers."""
    x, slot, band, m = _robust_edge(dev, s, "aligned")
    bar = _robust_large(dev, x, slot, band, m, s, kind, k)
    assert bool(bar.isnan().any()) and bool(bar.isinf().any())


@pytest.mark.parametrize("kind,k", [("trimmed", 3), ("median", 0)])
@pytest.mark.parametrize("s", [17, 33])
def test_robust_sum_large_s_past_its_list(dev, s, kind, k):
    """Twelve more rows on the first twelve slots: columns with up to s +
    12 owners, past the list's s + 8 slots (sorted in the buffer, then
    each later value inserted, the largest falling off)."""
    m = s + 2
    cols = np.random.default_rng(s).permutation(m)[:s].tolist()
    slots = cols + [-1, -1] + cols[:12]
    x, slot, band = _edge_inputs(dev, len(slots), "aligned", m, slots, 60 + s)
    x[0, 3::29], x[s + 2, 3::29] = 0.0, -0.0  # a zero tie, row order
    x[1, 5::31] = float("nan")
    _, cnt = ref.robust_sum(x, slot, band, m, s, kind, k)
    assert float(cnt.max()) > s + 8
    _robust_large(dev, x, slot, band, m, s, kind, k)


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("threads", [256, 128])
def test_robust_sum_large_s_at_each_block_size_edge(dev, threads, side):
    """n = s + 2 rows, so a column's list holds s + 2 values (its length
    is min(s + 8, n)): the largest s whose lists fit a block of
    ``threads`` columns (4 T (s + 2) bytes of shared memory within the
    per-block limit), then one more (128 columns; past 128 the lists in
    global memory).  These s sort by insertion."""
    props = torch.cuda.get_device_properties(dev)
    optin = getattr(props, "shared_memory_per_block_optin", 232448)
    s = optin // (4 * threads) - 2 + side
    x, slot, band, m = _robust_edge(dev, s, "aligned")
    _robust_large(dev, x, slot, band, m, s, "trimmed", 1)


@pytest.mark.parametrize("extra", [37, 64])
def test_robust_sum_large_s_on_a_row_pitch(dev, extra):
    """The first d columns of a wider workspace: a pitch off the 16-byte
    grid (scalar loads) and on it (16-byte loads)."""
    s = 33
    x, slot, band, m = _robust_edge(dev, s, "aligned")
    n, d = x.shape
    ws = torch.full((n, d + extra), float("nan"), device=dev)
    ws[:, :d] = x
    for kind, k in (("trimmed", 3), ("median", 0)):
        _robust_large(dev, ws[:, :d], slot, band, m, s, kind, k)


def _h_large(dev, case, covered):
    """Inputs past 4096 rows: a cohort of m rows on slots 0..m-1 (s = 2),
    idle rows NaN, ``down`` a quarter of the rows (``cohort``: the cohort,
    ``None``: every row)."""
    n, d, m, down_kind, pitch = {
        "pop8192": (8192, 2 * 4096 + 77, 64, "cohort", 0),
        "down_none": (4097, 4096 + 260, 64, None, 0),
        "rem1": (4097, 4096 + 1, 64, "quarter", 0),
        "rem3": (4097, 4096 + 3, 64, "quarter", 0),
        "pitch": (4097, 4096 + 260, 64, "quarter", 37),
        "list17": (5000, 4096 + 260, 17, "cohort", 0),
        "list_empty": (5000, 4096 + 260, 17, "none", 0),
    }[case]
    rng = np.random.default_rng(n + d)
    slot = np.full(n, -1, np.int32)
    members = rng.choice(n, m, replace=False)
    slot[members] = rng.permutation(m)
    if case == "list_empty":
        slot[:] = -1
    down = {"cohort": (slot >= 0).astype(np.int32),
            "quarter": (rng.random(n) < 0.25).astype(np.int32),
            "none": np.zeros(n, np.int32), None: None}[down_kind]
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[slot < 0] = np.nan
    h = rng.normal(size=(n, d)).astype(np.float32)
    band = rng.integers(0, m, size=d).astype(np.int32)
    band[::97] = -3  # outside [0, m): the general modulo
    x_bar = rng.normal(size=d).astype(np.float32)
    cov = rng.random(d) < 0.7 if covered else None
    to = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    ws = torch.full((2, n, d + pitch), float("nan"), device=dev)
    ws[0, :, :d], ws[1, :, :d] = to(x), to(h)
    return (ws[0, :, :d], ws[1, :, :d], to(x_bar), to(slot), to(band), m,
            to(down), to(cov))


@pytest.mark.parametrize("covered", [False, True])
@pytest.mark.parametrize("case", ["pop8192", "down_none", "rem1", "rem3",
                                  "pitch", "list17", "list_empty"])
def test_h_update_row_list_is_bitwise_plain(dev, case, covered):
    """Past 4096 rows in both forms: a population of 8192 with ``down`` the
    cohort, ``down=None``, d % 4 of 1 and 3, a row pitch off the 16-byte
    grid, a list one row longer than a 16-row tile and an empty list."""
    xk, hk, x_bar, slot, band, m, down, cov = _h_large(dev, case, covered)
    xp, hp = xk.clone(), hk.clone()
    name = ("h_update_covered" if covered else "h_update") + "_large_n"
    before = dict(_build.launch_counts)
    uplink.h_update(xk, hk, x_bar, slot, band, m, 2, 0.37, down=down,
                    covered=cov)
    assert {n for n in _build.launch_counts
            if _build.launch_counts[n] != before[n]} == {name}
    ref.h_update(xp, hp, x_bar, slot, band, m, 2, 0.37, down=down,
                 covered=cov)
    torch.cuda.synchronize()
    assert torch.equal(hk, hp)
    assert _same(xk, xp)


# -- the blockwise attention's backward and remat on the card --------------

def test_flash_backward_on_the_card_matches_the_chunk_loop(dev):
    """The recomputing backward against autograd through the chunk loop
    on the card, f32 at 2500 tokens (a ragged last block), window and
    softcap, GQA group 2: within 1e-5 of each gradient's largest entry
    (the two sum the blocks' contributions in other orders)."""
    from repro_torch.models import layers

    g = torch.Generator(device=dev).manual_seed(0)
    t, h, kvh, hd = 2500, 8, 4, 64
    q = torch.randn(1, t, h, hd, generator=g, device=dev,
                    requires_grad=True)
    k, v = (torch.randn(1, t, kvh, hd, generator=g, device=dev,
                        requires_grad=True) for _ in range(2))
    do = torch.randn(1, t, h, hd, generator=g, device=dev)
    out = []
    for fn in (layers.flash_attention, layers.flash_attention_plain):
        o = fn(q, k, v, window=700, attn_softcap=50.0)
        out.append((o, torch.autograd.grad(o, (q, k, v), do)))
    (o1, g1), (o2, g2) = out
    assert torch.equal(o1, o2)
    for a, b in zip(g1, g2):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_remat_on_the_card_matches_no_remat(dev):
    """Reduced gemma2-2b at 2304 tokens (the blockwise attention, a ragged
    last block): the loss and gradients with remat on the card equal those
    without it, bitwise."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.dist import model_api

    cfg = registry.get_reduced_config("gemma2-2b")
    params = model_api.init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (1, 2304), generator=gen,
                           device=dev)
    labels = torch.randint(0, cfg.vocab, (1, 2304), generator=gen,
                           device=dev)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        ps = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss, _ = model_api.loss(ps, c, tokens=tokens, labels=labels)
        out.append((loss, torch.autograd.grad(loss, list(ps.values()))))
    assert torch.isfinite(out[0][0]) and torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("row0,k", [(1, 3), (3, 2), (4, 1)])
def test_wire_quantize_row0_is_the_global_rows(dev, kind, row0, k):
    """A block of rows packed with ``row0`` (a rank's first global row)
    is bitwise the plain version with that ``row0`` and those rows of the
    whole workspace's pack."""
    from repro_torch.kernels import wire_pack

    dims = _WQ_DIMS["ragged"]
    offs = np.concatenate([[0], np.cumsum(dims)]).tolist()
    rng = np.random.default_rng(row0 * 10 + k)
    x = torch.from_numpy((rng.normal(size=(N, offs[-1])) * 3).astype(
        np.float32)).to(dev)
    x[2, 5] = float("nan")
    leaves = [(i, offs[i], dims[i]) for i in range(len(dims))]
    block = x[row0:row0 + k].contiguous()
    before = _build.launch_counts["wire_quantize"]
    codes, scales = wire_pack.pack_int(block, leaves, kind, 0xC0FFEE,
                                       row0=row0)
    whole_c, whole_s = wire_pack.pack_int(x, leaves, kind, 0xC0FFEE)
    assert _build.launch_counts["wire_quantize"] == before + 2
    codes_p, scales_p = ref.wire_pack(block, leaves, kind, 0xC0FFEE, row0)
    torch.cuda.synchronize()
    assert torch.equal(codes, codes_p)
    assert torch.equal(scales.view(torch.int32), scales_p.view(torch.int32))
    assert torch.equal(codes, whole_c[row0:row0 + k])
    assert torch.equal(scales.view(torch.int32),
                       whole_s[row0:row0 + k].view(torch.int32))


# the two-rank shard comm step on one card: n = 4, c = 3, s = 2, an idle
# row of NaN; the mean, survivor and int8-wire (wire_down) rebuilds
_SHARD_VARIANTS = ("mean", "survivor", "int8_down")


def _shard_case(dev, variant, group=None):
    from repro_torch.dist import comm_ws

    n, c, s, d = 4, 3, 2, 3 * 4096 + 77
    dims = [4096 + 5, d - 4096 - 5]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[1] = np.nan
    h = rng.normal(size=(n, d)).astype(np.float32)
    slot = torch.tensor([2, -1, 0, 1], dtype=torch.int32, device=dev)
    down = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    arrived = (torch.tensor([True, False, False, True], device=dev)
               if variant == "survivor" else None)
    band = comm_ws.cyclic_band(dims, c, s, dev)
    wire = (comm_ws.wire_plan(dims, "int8", c, s, band)
            if variant == "int8_down" else None)
    rows = slice(0, n) if group is None else slice(group.row0, group.stop)
    xw = torch.from_numpy(x[rows]).to(dev)
    hw = torch.from_numpy(h[rows]).to(dev)
    kw = dict(down=down, arrived=arrived, wire=wire, wire_seed=99,
              wire_down=wire is not None)
    if group is None:
        comm_ws.cyclic_comm(xw, hw, slot, band, c, s, 0.37, **kw)
    else:
        comm_ws.shard_comm(xw, hw, slot, band, c, s, 0.37, group=group, **kw)
    return xw.cpu().numpy(), hw.cpu().numpy()


def _shard_rank(rank, dev, out_dir):
    from repro_torch.dist import sharding

    out = {}
    for variant in _SHARD_VARIANTS:
        g = sharding.RankRows.of_group(4)
        out[f"{variant}/x"], out[f"{variant}/h"] = _shard_case(dev, variant,
                                                               g)
        out[f"{variant}/sizes"] = np.asarray(g.sizes)
    out["launches"] = np.asarray([_build.launch_counts[k] for k in (
        "masked_sum", "masked_sum_counts", "masked_sum_dequant",
        "h_update", "h_update_covered", "wire_quantize")])
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


def test_two_gloo_ranks_on_one_card_match_the_kernel_path(dev, tmp_path):
    """Two ranks on cuda:0 over gloo (``sharding.spawn``) run the shard
    engine on their rows with the kernels; bitwise the one-process kernel
    path at s = 2, every collective d-sized."""
    from repro_torch.dist import sharding

    _build.load()  # built once, before the ranks
    sharding.spawn(_shard_rank, 2, backend="gloo", device="cuda",
                   init_method=sharding.file_init_method(str(tmp_path)),
                   args=(str(tmp_path),))
    parts = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for variant in _SHARD_VARIANTS:
        want_x, want_h = _shard_case(dev, variant)
        got_x = np.concatenate([p[f"{variant}/x"] for p in parts])
        got_h = np.concatenate([p[f"{variant}/h"] for p in parts])
        assert np.array_equal(got_x, want_x, equal_nan=True), variant
        assert np.array_equal(got_h, want_h, equal_nan=True), variant
        for p in parts:
            assert int(p[f"{variant}/sizes"].max()) <= 3 * 4096 + 77
    for p in parts:  # each rank launched the UpComs, quantizer, updates
        assert all(int(v) > 0 for v in p["launches"])


# --------------------------------------------------------------------------
# the coordinate-table forms (model-sharded blocks)
# --------------------------------------------------------------------------


def _at_group(dev, n=5, seed=3):
    """A kind group of three blocks: rank 1's of a (6, 100) leaf split on
    dim 0, rank 0's of a (5, 64) leaf split on dim 1 and a whole (29,)
    leaf, each block's chunks straddling the split; its leaves
    ``(index, offset, size)``, global sizes, coordinates, a workspace
    with +inf, -inf and NaN, and positive scales over the global chunks."""
    from repro_torch.dist import sharding, wire

    blocks = [((6, 100), (True, False), 1), ((5, 64), (False, True), 0),
              ((29,), (False,), 0)]
    leaves, gdims, ks, o = [], [], [], 3
    for i, (shape, spec, m) in enumerate(blocks):
        k = sharding.shard_coords(shape, spec, 2, m)
        k = (np.arange(int(np.prod(shape))) if k is None
             else k.numpy())
        leaves.append((i + 2, o, k.size))
        gdims.append(int(np.prod(shape)))
        ks.append(k)
        o += k.size + 5
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, o)).astype(np.float32)
    x[0, 10] = np.inf
    x[2, 200] = -np.inf
    x[3, 333] = np.nan
    nc = sum(wire.n_chunks(G) for G in gdims)
    scales = rng.uniform(0.001, 0.05, size=(n, nc)).astype(np.float32)
    coords = torch.from_numpy(np.concatenate(ks).astype(np.int64)).to(dev)
    return (leaves, gdims, coords, torch.from_numpy(x).to(dev),
            torch.from_numpy(scales).to(dev))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_wire_quantize_at_kernel_matches_plain(dev, kind):
    """The UpCom and the DownCom of the coordinate-table form bitwise
    against ``ref.wire_pack``/``ref.wire_down`` with the same coordinates
    and scales; the UpCom's scales come back poisoned where a row's chunk
    holds a nonfinite value, the input scales untouched."""
    from repro_torch.kernels import wire_pack

    leaves, gdims, coords, x, scales = _at_group(dev)
    kw = dict(coords=coords, scales=scales, gdims=gdims)
    before = _build.launch_counts["wire_quantize_at"]
    keep = scales.clone()
    codes, sc = wire_pack.pack_int(x, leaves, kind, 0x5EED, row0=3, **kw)
    codes_p, sc_p = ref.wire_pack(x, leaves, kind, 0x5EED, 3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(codes, codes_p)
    assert torch.equal(sc.isnan(), sc_p.isnan()) and int(sc.isnan().sum())
    assert torch.equal(torch.nan_to_num(sc), torch.nan_to_num(sc_p))
    assert torch.equal(scales, keep)
    row = x[1].clone()
    row[17] = float("nan")
    got, want = row.clone(), row.clone()
    dkw = dict(kw, scales=scales[:1].contiguous())
    wire_pack.quantize_down(got, leaves, kind, 0x5EED, **dkw)
    ref.wire_down(want, leaves, kind, 0x5EED, **dkw)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert _build.launch_counts["wire_quantize_at"] == before + 2


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("d", [4096 + 512, 4096 + 77])
def test_masked_sum_dequant_at_kernel_matches_plain(dev, counts, d):
    """The scale-column form bitwise against the plain version with the
    same table, on the 16-byte path (d % 4 == 0) and off it; an idle
    row's NaN scales never leak."""
    rng = np.random.default_rng(d)
    n, nc = 5, 40
    codes = torch.from_numpy(rng.integers(-127, 128, size=(n, d)).astype(
        np.int8)).to(dev)
    scales = torch.from_numpy(rng.uniform(0.001, 0.05, size=(n, nc)).astype(
        np.float32)).to(dev)
    scales[1] = float("nan")
    col = torch.from_numpy(np.sort(rng.integers(0, nc, size=d)).astype(
        np.int32)).to(dev)
    band = torch.from_numpy(rng.integers(0, M, size=d).astype(np.int32)).to(
        dev)
    slot = torch.tensor([2, -1, 0, 3, 1], dtype=torch.int32, device=dev)
    lo = (0, d // 3, d)
    name = "masked_sum_dequant" + ("_counts" if counts else "") + "_at"
    before = _build.launch_counts[name]
    got = uplink.masked_sum_dequant(codes, scales, lo, slot, band, M, S,
                                    counts=counts, chunk_col=col)
    want = ref.masked_sum_dequant(codes, scales, torch.tensor(lo, device=dev),
                                  slot, band, M, S, counts=counts,
                                  chunk_col=col)
    torch.cuda.synchronize()
    for a, b in zip(got if counts else (got,), want if counts else (want,)):
        assert torch.equal(a, b)
    assert _build.launch_counts[name] == before + 1


def test_the_old_wire_forms_launch_as_before(dev):
    """Without the tables the quantizer and the dequantizing UpCom launch
    their old kernels, counted under their old names, bitwise as their
    plain versions; the table forms' counts stay put."""
    from repro_torch.kernels import wire_pack

    x, _, band, slot = _inputs(dev, 4)
    x = x.nan_to_num()
    leaves = [(0, 0, 1000), (1, 1000, D - 1000)]
    names = ("wire_quantize", "wire_quantize_at", "masked_sum_dequant",
             "masked_sum_dequant_at")
    before = {k: _build.launch_counts[k] for k in names}
    codes, scales = wire_pack.pack_int(x, leaves, "int8", 7)
    codes_p, scales_p = ref.wire_pack(x, leaves, "int8", 7)
    lo = (0, 1000, D)
    bar = uplink.masked_sum_dequant(codes, scales, lo, slot, band, M, S)
    bar_p = ref.masked_sum_dequant(codes, scales,
                                   torch.tensor(lo, device=dev), slot, band,
                                   M, S)
    torch.cuda.synchronize()
    assert torch.equal(codes, codes_p) and torch.equal(scales, scales_p)
    assert torch.equal(bar, bar_p)
    after = {k: _build.launch_counts[k] - before[k] for k in names}
    assert after == {"wire_quantize": 1, "wire_quantize_at": 0,
                     "masked_sum_dequant": 1, "masked_sum_dequant_at": 0}
