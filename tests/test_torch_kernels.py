"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the reference's Pallas kernels in interpret mode, on the same
seeded numpy inputs: a ragged width, an idle client (slot -1) whose row
holds NaN, and the DownCom both to every row and to a row mask;
``masked_sum`` also at n = 1, 5 and 9 rows with bands outside [0, m).

Tolerances: ``h_update`` and ``fused_local_step`` repeat the reference's
arithmetic operation for operation, so they agree bitwise; ``masked_sum``
may add the client rows in another order, so 1e-6 relative.  ``compress``
(the convex core's C_i) selects, so it agrees bitwise in f32 and f64 (the
reference's f64 run under a scoped ``jax.enable_x64``), unowned NaN and
inf included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import comm_ws as jcomm
from repro.kernels import compress as jcompress
from repro.kernels import ops as jops
from repro.kernels import local_step as jlocal
from repro.kernels import uplink as juplink
from repro_torch.dist import comm_ws
from repro_torch.kernels import _build, compress, local_step, uplink

N, D, M, S = 5, 3 * 4096 + 77, 4, 2
SLOT = np.array([2, -1, 0, 3, 1], np.int32)  # row 1 idle


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x[1] = np.nan  # the idle row may hold anything
    h = rng.normal(size=(N, D)).astype(np.float32)
    x_bar = rng.normal(size=(D,)).astype(np.float32)
    band = rng.integers(0, M, size=(D,)).astype(np.int32)
    return x, h, x_bar, band


def test_owned_from_band_and_cyclic_band_match_reference():
    slot = np.arange(-2, 2 * M, dtype=np.int32)[:, None]
    band = np.arange(-M, 2 * M, dtype=np.int32)[None, :]
    want = np.asarray(jcompress.owned_from_band(
        jnp.asarray(slot), jnp.asarray(band), M, S))
    got = compress.owned_from_band(torch.from_numpy(slot),
                                   torch.from_numpy(band), M, S).numpy()
    np.testing.assert_array_equal(got, want)
    k = np.arange(50, dtype=np.int32)
    np.testing.assert_array_equal(
        compress.cyclic_band(torch.from_numpy(k), 7, 3).numpy(),
        np.asarray(jcompress.cyclic_band(jnp.asarray(k), 7, 3)))


@pytest.mark.parametrize("dims,c,s", [((5, 12, 7), 3, 2), ((4097, 30), 4, 3),
                                      ((10, 10), 5, 5)])
def test_cyclic_band_table_matches_reference(dims, c, s):
    got = comm_ws.cyclic_band(dims, c, s, "cpu").numpy()
    np.testing.assert_array_equal(got, jcomm._cyclic_band_np(dims, c, s))


def test_masked_sum_matches_pallas_interpret():
    x, _, _, band = _inputs()
    want = np.asarray(juplink.masked_sum(
        jnp.asarray(x), jnp.asarray(SLOT), jnp.asarray(band), M, S,
        interpret=True))
    got = uplink.masked_sum(torch.from_numpy(x), torch.from_numpy(SLOT),
                            torch.from_numpy(band), M, S).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# n rows with idle and dropped rows of NaN; "outside": bands outside
# [0, m), negative and >= m (the CUDA kernel's scalar path).  D % 4 != 0.
_EDGE_SLOTS = {1: [1], 5: [2, -1, 0, 3, 1],
               9: [2, -1, 0, 3, 1, -1, 3, 2, 0]}


@pytest.mark.parametrize("bands", ["in_range", "outside"])
@pytest.mark.parametrize("n", [1, 5, 9])
def test_masked_sum_matches_pallas_interpret_at_edges(n, bands):
    rng = np.random.default_rng(n)
    slot = np.array(_EDGE_SLOTS[n], np.int32)
    x = rng.normal(size=(n, D)).astype(np.float32)
    x[slot < 0] = np.nan
    band = rng.integers(0, M, size=(D,)).astype(np.int32)
    if bands == "outside":
        band[::97] = -3
        band[5::89] = M + 3
        band[7::101] = -M - 1
    want = np.asarray(juplink.masked_sum(
        jnp.asarray(x), jnp.asarray(slot), jnp.asarray(band), M, S,
        interpret=True))
    got = uplink.masked_sum(torch.from_numpy(x), torch.from_numpy(slot),
                            torch.from_numpy(band), M, S).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("down", [None, np.array([1, 0, 1, 0, 1], np.int32)])
def test_h_update_matches_pallas_interpret_bitwise(down):
    x, h, x_bar, band = _inputs(1)
    scale = 0.37
    h_want, x_want = juplink.h_update(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(x_bar),
        jnp.asarray(SLOT), jnp.asarray(band), M, S, scale,
        down=None if down is None else jnp.asarray(down), interpret=True)
    xt, ht = torch.from_numpy(x.copy()), torch.from_numpy(h.copy())
    uplink.h_update(xt, ht, torch.from_numpy(x_bar), torch.from_numpy(SLOT),
                    torch.from_numpy(band), M, S, scale,
                    down=None if down is None else torch.from_numpy(down))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(h_want))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(x_want))
    if down is not None:
        # rows outside down keep x bit for bit, NaN payload included
        keep = down == 0
        assert xt.numpy()[keep].tobytes() == x[keep].tobytes()
    # the idle row owns nothing: its h is untouched
    assert ht.numpy()[1].tobytes() == h[1].tobytes()


@pytest.mark.parametrize("shape", [(D,), (37, 129), (2, 64, 96)])
def test_fused_local_step_matches_pallas_interpret(shape):
    """Bitwise equal to the kernel body's arithmetic with every operation
    rounded (``x - gamma (g - h)`` in numpy f32).  XLA:CPU contracts the
    same body into one FMA, so the Pallas interpret run differs by at most
    the rounding of the product ``gamma (g - h)``: within one ulp of the
    product plus one ulp of the result."""
    rng = np.random.default_rng(2)
    x, g, h = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    gamma = 0.05
    prod = np.float32(gamma) * (g - h)
    rounded = x - prod
    want = np.asarray(jlocal.fused_local_step(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(h), gamma,
        interpret=True))
    xt = torch.from_numpy(x.copy())
    got = local_step.fused_local_step(xt, torch.from_numpy(g),
                                      torch.from_numpy(h), gamma).numpy()
    np.testing.assert_array_equal(got, rounded)
    tol = np.spacing(np.abs(prod)) + np.spacing(np.abs(want))
    assert (np.abs(got - want) <= tol).all()
    # in place into x gives the same bits
    local_step.fused_local_step(xt, torch.from_numpy(g), torch.from_numpy(h),
                                gamma, out=xt)
    np.testing.assert_array_equal(xt.numpy(), rounded)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(3, 8)
    slot = torch.zeros(3, dtype=torch.int32)
    band = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        uplink.masked_sum(x.double(), slot, band, 2, 2)
    with pytest.raises(ValueError):
        uplink.masked_sum(x, slot.long(), band, 2, 2)
    with pytest.raises(ValueError):
        uplink.masked_sum(x.t(), slot, torch.zeros(3, dtype=torch.int32),
                          2, 2)
    with pytest.raises(ValueError):
        uplink.h_update(x, torch.zeros(3, 7), torch.zeros(8), slot, band,
                        2, 2, 1.0)
    with pytest.raises(ValueError):
        local_step.fused_local_step(x, x.t().contiguous().t(), x, 0.1)
    # CPU tensors never reach a kernel: nothing is launched or counted
    before = dict(_build.launch_counts)
    uplink.masked_sum(x, slot, band, 2, 2)
    assert _build.launch_counts == before


# -- compress (C_i of the convex core) ---------------------------------------

C_C, S_C = 8, 3
SLOTS_2D = np.array([0, 3, 7, 8, -1, 11], np.int32)  # in [0, c), >= c, < 0


def _compress_input(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(dtype)
    flat = x.reshape(-1)
    flat[5::97] = np.nan  # unowned NaN and inf must not leak
    flat[11::89] = np.inf
    flat[13::83] = -0.0
    return x


def _pallas_compress(x, slot, block):
    with jax.enable_x64(x.dtype == np.float64):
        return np.asarray(jops.compress(jnp.asarray(x), jnp.asarray(slot),
                                        C_C, S_C, block=block))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compress_2d_matches_pallas_interpret_bitwise(dtype):
    x = _compress_input((len(SLOTS_2D), 3 * 256 + 77), dtype, 7)
    want = _pallas_compress(x, SLOTS_2D, 256)
    assert want.dtype == dtype
    got = compress.compress(torch.from_numpy(x), torch.from_numpy(SLOTS_2D),
                            C_C, S_C).numpy()
    assert got.dtype == dtype and got.tobytes() == want.tobytes()
    # slots outside [0, c) give zero rows
    assert not got[3:].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("slot", [0, 5, 7, 8, 20, -1])
def test_compress_1d_matches_pallas_interpret_bitwise(dtype, slot):
    x = _compress_input((1000,), dtype, slot + 3)
    sl = np.array([slot], np.int32)
    want = _pallas_compress(x, sl, 128)
    got = compress.compress(torch.from_numpy(x), torch.from_numpy(sl), C_C,
                            S_C).numpy()
    assert got.dtype == dtype and got.tobytes() == want.tobytes()


def test_compress_owners_cover_each_coordinate_s_times():
    x = torch.ones(C_C, 257, dtype=torch.float64)
    slot = torch.arange(C_C, dtype=torch.int32)
    total = compress.compress(x, slot, C_C, S_C).sum(dim=0)
    assert torch.equal(total, torch.full((257,), float(S_C),
                                         dtype=torch.float64))


def test_compress_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(3, 8, dtype=torch.float64)
    slot = torch.zeros(3, dtype=torch.int32)
    for bad in (lambda: compress.compress(x.half(), slot, 4, 2),
                lambda: compress.compress(x, slot.long(), 4, 2),
                lambda: compress.compress(x, slot[:2], 4, 2),
                lambda: compress.compress(x.t(), slot, 4, 2),
                lambda: compress.compress(x[0], slot, 4, 2),
                lambda: compress.compress(x, slot, 4, 5)):
        with pytest.raises(ValueError):
            bad()
    before = dict(_build.launch_counts)
    compress.compress(x, slot, 4, 2)
    assert _build.launch_counts == before
