"""The port's CUDA kernels against their plain versions on the card, at a
small ragged width with an idle row of NaN.  These tests need an NVIDIA GPU
with nvcc (``-m cuda``) and skip elsewhere; ``chip_smoke.py`` repeats the
comparison at the main path's full shapes.

Every kernel repeats its plain version's arithmetic operation for
operation with no FMA contraction, so they agree bitwise (NaN where the
plain version has NaN).
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
