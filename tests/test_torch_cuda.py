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
    with pytest.raises(ValueError):
        uplink.robust_sum(x, slot, band, 32, 17, kind="median")


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


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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

    q = torch.zeros(1, 4, 80, device=dev)
    k = torch.zeros(1, 8, 2, 80, device=dev)
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
