"""The chunk maxima of the model-sharded int wire's scales on the CPU.

``kernels.ref.chunk_max_at`` (the plain version of the ``chunk_max_at``
kernel) and ``wire.chunk_max_at``/``leaf_scales_at`` on a CPU tensor are
held bitwise against the reference's ``repro.dist.wire.leaf_scales_at``,
run eagerly (under ``jax.jit`` XLA turns its ``/ levels`` into a
multiplication, see ``tests/test_torch_wire.py``): the scales, and the
maxima before its floor against the reference's own scatter-max
operations.  The blocks are model rank 0's and 1's of leaves split on rows
and on columns, some whole 256-coordinate runs (the kernels' whole-run
form) and some not (runs of 100 and 300 coordinates), with +-inf, NaN and
-0 entries.  The group form (``wire_pack.chunk_max_at``: one call over a
kind group's leaves) equals the per-leaf calls, counts no launch on the
CPU, and the table forms refuse a whole-run flag table of the wrong length
or a flag on a block that is not whole runs.  The kernels themselves are
held against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import wire as jwire
from repro_torch.dist import comm_ws, sharding, wire
from repro_torch.kernels import _build, ref, wire_pack


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as ``tests/test_torch_wire.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# (leaf shape, which dims split over 2 model ranks): whole runs of 2048
# and 512 coordinates, then runs of 300, 100 and 300
BLOCKS = {
    "rows_whole": ((8, 512), (True, False)),
    "cols_whole": ((4, 1024), (False, True)),
    "rows_300": ((6, 100), (True, False)),
    "cols_100": ((4, 200), (False, True)),
    "cols_300": ((4, 600), (False, True)),
}


def _leaf(shape, rows=3, seed=0):
    """``(rows,) + shape`` f32 with +-inf, NaN, -0 and an all-zero run,
    spread over both model ranks' blocks."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows,) + shape)
         * np.exp(2 * rng.normal(size=(rows, 1, 1)))).astype(np.float32)
    flat = x.reshape(rows, -1)
    D = flat.shape[1]
    flat[0, 7] = np.inf
    flat[1 % rows, D - 3] = -np.inf
    flat[2 % rows, D // 2] = np.nan
    flat[0, 1::97] = -0.0
    flat[1 % rows, 256:min(D, 512)] = 0.0
    return x


def _block(x, shape, spec, m):
    """Model rank ``m``'s block of ``x`` as ``(rows, d_local)`` and its
    global coordinates."""
    k = sharding.shard_coords(shape, spec, 2, m)
    blk = x[(slice(None),) + sharding.block_slices(shape, spec, 2, m)]
    return np.ascontiguousarray(blk.reshape(x.shape[0], -1)), k


def _reference_max(blk, k, nc):
    """The reference's scatter-max before its floor: the first lines of
    ``repro.dist.wire.leaf_scales_at``, eagerly."""
    xj = jnp.asarray(blk)
    a = jnp.where(jnp.isfinite(xj), jnp.abs(xj), 0.0)
    mx = jnp.zeros((blk.shape[0], nc), jnp.float32)
    return mx.at[:, jnp.asarray(k.numpy()) // jwire.CHUNK].max(a)


@pytest.mark.parametrize("case", sorted(BLOCKS))
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_chunk_max_at_is_the_reference_leaf_scales_at(kind, case):
    shape, spec = BLOCKS[case]
    x = _leaf(shape, seed=len(case))
    D = int(np.prod(shape))
    nc = wire.n_chunks(D)
    runs = []
    for m in range(2):
        blk, k = _block(x, shape, spec, m)
        whole = comm_ws.whole_chunks(k)
        runs.append(whole)
        want = _reference_max(blk, k, nc)
        xt = torch.from_numpy(blk)
        for got in (ref.chunk_max_at(xt, k, nc),
                    ref.chunk_max_at(xt, k, nc, whole_chunks=whole),
                    wire.chunk_max_at(xt, k, nc),
                    wire.chunk_max_at(xt, k, nc, whole_chunks=whole)):
            assert _bits_equal(got.numpy(), want), (case, m)
        sj = jwire.leaf_scales_at(jnp.asarray(blk), jnp.asarray(k.numpy()),
                                  nc, kind)
        st = wire.leaf_scales_at(xt, k, nc, kind)
        assert _bits_equal(st.numpy(), sj), (case, m)
    # runs of 300 or 100 coordinates are no whole runs, 2048 and 512 are
    assert runs == [case.endswith("whole")] * 2


def _group(rows=4, seed=1):
    """A kind group of model rank 1's blocks of every leaf of BLOCKS, laid
    in a workspace row with gaps and an odd first offset: ``(x, leaves,
    coords, gdims, runs)``."""
    xs, leaves, ks, gdims, runs, o = [], [], [], [], [], 3
    for i, name in enumerate(sorted(BLOCKS)):
        shape, spec = BLOCKS[name]
        blk, k = _block(_leaf(shape, rows, seed + i), shape, spec, 1)
        leaves.append((i + 4, o, k.numel()))
        ks.append(k)
        gdims.append(int(np.prod(shape)))
        runs.append(comm_ws.whole_chunks(k))
        xs.append((o, blk))
        o += k.numel() + 5
    x = np.random.default_rng(seed).normal(size=(rows, o)).astype(np.float32)
    for a, blk in xs:
        x[:, a:a + blk.shape[1]] = blk
    return (torch.from_numpy(x), tuple(leaves), torch.cat(ks),
            tuple(gdims), tuple(runs))


@pytest.mark.parametrize("rows", [1, 4])
def test_group_form_equals_the_per_leaf_calls(rows):
    """One ``wire_pack.chunk_max_at`` over the group's leaves is each
    leaf's ``wire.chunk_max_at`` in its scale columns; with ``out`` it
    maxes into the given maxima; ``comm_ws._group_scales`` is its
    ``scales_of_max``."""
    x, leaves, coords, gdims, runs = _group(rows)
    assert runs == tuple(nm.endswith("whole") for nm in sorted(BLOCKS))
    got = wire_pack.chunk_max_at(x, leaves, coords=coords, gdims=gdims,
                                 runs=runs)
    want, g0 = [], 0
    for (_, o, D), G, r in zip(leaves, gdims, runs):
        want.append(wire.chunk_max_at(x[:, o:o + D], coords[g0:g0 + D],
                                      wire.n_chunks(G), whole_chunks=r))
        g0 += D
    want = torch.cat(want, dim=1)
    assert torch.equal(got, want)
    base = torch.rand(rows, want.shape[1], generator=torch.Generator()
                      .manual_seed(rows))
    into = base.clone()
    assert wire_pack.chunk_max_at(x, leaves, coords=coords, gdims=gdims,
                                  runs=runs, out=into) is into
    assert torch.equal(into, torch.maximum(base, want))
    grp = comm_ws.WireGroup(
        kind="int8", leaves=leaves, leaf_lo=(), band=torch.empty(0),
        whole=False, gdims=gdims, coords=coords, runs=runs)
    assert torch.equal(comm_ws._group_scales(x, grp),
                       wire.scales_of_max(want, "int8"))


def test_the_wrappers_count_no_launch_on_the_cpu():
    x, leaves, coords, gdims, runs = _group(2)
    before = dict(_build.launch_counts)
    mx = wire_pack.chunk_max_at(x, leaves, coords=coords, gdims=gdims,
                                runs=runs)
    sc = wire.scales_of_max(mx, "int8")
    kw = dict(coords=coords, gdims=gdims, runs=runs)
    codes, out = wire_pack.pack_int(x, leaves, "int8", 11, scales=sc, **kw)
    codes_p, out_p = ref.wire_pack(x, leaves, "int8", 11, coords=coords,
                                   scales=sc, gdims=gdims)
    assert torch.equal(codes, codes_p)
    assert torch.equal(out.isnan(), out_p.isnan())
    assert int(out.isnan().sum()) > 0
    row = x[0].clone()
    wire_pack.quantize_down(row, leaves, "int8", 11, scales=sc[:1], **kw)
    assert dict(_build.launch_counts) == before


@pytest.mark.parametrize("entry", ["_at_tables", "chunk_max_at", "pack_int",
                                   "quantize_down"])
def test_table_forms_refuse_a_wrong_flag_table(entry):
    """A whole-run flag table one short or one long, or a flag on a block
    that is not whole 256-coordinate runs, is refused."""
    x, leaves, coords, gdims, runs = _group(1)
    sc = torch.ones(1, sum(wire.n_chunks(G) for G in gdims))

    def call(flags):
        if entry == "_at_tables":
            return wire_pack._at_tables(x, leaves, coords, gdims, flags)
        if entry == "chunk_max_at":
            return wire_pack.chunk_max_at(x, leaves, coords=coords,
                                          gdims=gdims, runs=flags)
        kw = dict(coords=coords, scales=sc, gdims=gdims, runs=flags)
        if entry == "pack_int":
            return wire_pack.pack_int(x, leaves, "int8", 3, **kw)
        return wire_pack.quantize_down(x[0].clone(), leaves, "int8", 3, **kw)

    call(runs)
    for bad in (runs[:-1], runs + (False,), (True,) * len(runs)):
        with pytest.raises(ValueError, match="whole-run flag"):
            call(bad)
    if entry == "_at_tables":
        at, nc = call(runs)
        assert nc == sc.shape[1] and at[2::3] == tuple(map(int, runs))
        assert call(None)[0][2::3] == (0,) * len(runs)
