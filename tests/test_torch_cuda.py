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


def test_masked_sum_kernel_matches_plain(dev):
    x, _, band, slot = _inputs(dev)
    before = _build.launch_counts["masked_sum"]
    got = uplink.masked_sum(x, slot, band, M, S)
    assert _build.launch_counts["masked_sum"] == before + 1
    want = ref.masked_sum(x, slot, band, M, S)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


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


def test_masked_sum_counts_kernel_matches_plain(dev):
    x, _, band, slot = _inputs(dev)
    before = _build.launch_counts["masked_sum_counts"]
    num, cnt = uplink.masked_sum(x, slot, band, M, S, counts=True)
    assert _build.launch_counts["masked_sum_counts"] == before + 1
    num_p, cnt_p = ref.masked_sum_counts(x, slot, band, M, S)
    torch.cuda.synchronize()
    assert torch.equal(num, num_p) and torch.equal(cnt, cnt_p)


@pytest.mark.parametrize("kind,k,s", [("trimmed", 1, 3), ("median", 0, 3),
                                      ("trimmed", 1, 4), ("median", 0, 4)])
def test_robust_sum_kernel_matches_plain(dev, kind, k, s):
    x, _, band, slot = _inputs(dev, 2)
    x[0, ::7] = x[2, ::7]  # ties
    x[0, ::101] = float("inf")
    x[3, 50::101] = float("-inf")
    x[4, 9::57] = float("nan")  # an owned NaN
    before = _build.launch_counts["robust_sum"]
    bar, cnt = uplink.robust_sum(x, slot, band, M, s, kind=kind, k=k)
    assert _build.launch_counts["robust_sum"] == before + 1
    bar_p, cnt_p = ref.robust_sum(x, slot, band, M, s, kind, k)
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt_p)
    assert _same(bar, bar_p)


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


def _lo(dims, dev):
    return torch.tensor(np.concatenate([[0], np.cumsum(dims)]),
                        dtype=torch.int64, device=dev)


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
    lo = _lo(dims, dev)
    name = "masked_sum_dequant_counts" if counts else "masked_sum_dequant"
    before = _build.launch_counts[name]
    got = uplink.masked_sum_dequant(codes, scales, lo, slot, band, M, S,
                                    counts=counts)
    assert _build.launch_counts[name] == before + 1
    want = ref.masked_sum_dequant(codes, scales, lo, slot, band, M, S,
                                  counts=counts)
    torch.cuda.synchronize()
    if not counts:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert 0 < int(got[0].isnan().sum()) < 256


@pytest.mark.parametrize("lane", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("counts", [False, True])
def test_narrow_lane_masked_sum_kernel_matches_plain(dev, lane, counts):
    x, _, band, slot = _inputs(dev, 5)
    xl = x.to(lane)
    suffix = "_f16" if lane == torch.float16 else "_bf16"
    name = ("masked_sum_counts" if counts else "masked_sum") + suffix
    before = _build.launch_counts[name]
    got = uplink.masked_sum(xl, slot, band, M, S, counts=counts)
    assert _build.launch_counts[name] == before + 1
    want = (ref.masked_sum_counts(xl, slot, band, M, S) if counts
            else ref.masked_sum(xl, slot, band, M, S))
    torch.cuda.synchronize()
    if not counts:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)


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
