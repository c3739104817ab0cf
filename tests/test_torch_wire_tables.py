"""The int wire's host-side tables against a brute-force enumeration.

The quantizer's and the dequantizing UpCom's kernels index a kind group
through small tables that the wrappers build on the host and copy to the
card once (``wire_pack._tables``, ``uplink._leaf_starts`` with
``compress.chunk_offsets``, ``_build.device_table``).  These CPU tests walk
every coordinate of ragged groups (leaves of one coordinate, sizes and
offsets off every power of two, leaves out of row order) and hold what the
kernels read from those tables, in the kernels' own arithmetic, against a
coordinate-by-coordinate enumeration: the quantizer's (row column, group
column, leaf coordinate, leaf index, scale column) of each chunk, and the
UpCom's scale column of each coordinate and its split of 512-column warp
blocks into the 16-byte path (one leaf, one scale column per 4-column
quad, rows on the grid) and the scalar one.  They also hold the wrappers'
refusals.
"""

import bisect

import pytest
import torch

from repro_torch.dist import comm_ws, wire
from repro_torch.kernels import _build, compress, uplink, wire_pack

CHUNK, BLOCK = 256, 512
# (row width, leaves as (leaf index, offset in the row, size)); the
# leaves of a group need not be in row order nor cover the row
LAYOUTS = {
    "ragged": (2400, [(0, 0, 1), (1, 1, 15), (2, 16, 17), (3, 33, 255),
                      (4, 288, 257), (5, 545, 1000), (6, 1545, 855)]),
    "subset": (3000, [(4, 1200, 513), (1, 7, 300), (7, 2999, 1),
                      (2, 400, 256)]),
    "aligned": (4096, [(0, 0, 256), (1, 256, 1024), (2, 1280, 2816)]),
    # a leaf that starts 4 columns past a chunk boundary: the quads of one
    # lane read different scale columns
    "quads": (4000, [(0, 0, 4), (1, 4, 2044), (2, 2048, 1952)]),
}
# the UpCom's blocks on the 16-byte path in each layout
VECTOR_BLOCKS = {"ragged": 0, "subset": 0, "aligned": 6, "quads": 6}


def _enumerate(leaves, dst_of_src):
    """Every coordinate of the group in order: (row column, output
    column, leaf coordinate, leaf index, group scale column)."""
    out, q, col0 = [], 0, 0
    for li, o, D in leaves:
        for k in range(D):
            out.append((o + k, o + k if dst_of_src else q, k, li,
                        col0 + k // CHUNK))
            q += 1
        col0 += -(-D // CHUNK)
    return out


@pytest.mark.parametrize("dst_of_src", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_quantizer_tables_reach_every_coordinate_once(layout, dst_of_src):
    _, leaves = LAYOUTS[layout]
    tab, coff = wire_pack._tables(leaves, dst_of_src)
    assert len(tab) == 4 * len(leaves) and len(coff) == len(leaves) + 1
    assert coff[-1] == sum(wire.n_chunks(D) for _, _, D in leaves)
    got = []
    for chunk in range(coff[-1]):  # wire_quantize_kernel's indexing
        j = bisect.bisect_right(coff[:-1], chunk) - 1
        k0 = (chunk - coff[j]) * CHUNK
        n = min(tab[4 * j + 1] - k0, CHUNK)
        assert 0 < n <= CHUNK
        got += [(tab[4 * j] + k0 + p, tab[4 * j + 2] + k0 + p, k0 + p,
                 tab[4 * j + 3], chunk) for p in range(n)]
    assert got == _enumerate(leaves, dst_of_src)


def _lane_cols(w0, lane):
    """A lane's 16 columns of the warp's 512: four quads, 128 apart."""
    return [w0 + 128 * q + 4 * lane + e for q in range(4) for e in range(4)]


def _blocks(lo, d):
    """masked_sum_dequant_kernel's walk over blocks of 512 columns: for
    each block, each lane's four quad scale columns on the 16-byte path
    (None for the scalar path); and each column's scale column as the
    scalar path finds it, in column order."""
    coff = compress.chunk_offsets(lo)
    grid16 = d % 4 == 0
    vec, cols, j = [], {}, 0
    for w0 in range(0, d, BLOCK):
        while lo[j + 1] <= w0:
            j += 1
        if grid16 and w0 + BLOCK <= lo[j + 1] and lo[j] % 4 == 0:
            vec.append([[coff[j] + (w0 + 128 * q + 4 * lane - lo[j]) // CHUNK
                         for q in range(4)] for lane in range(32)])
        else:
            vec.append(None)
        for lane in range(32):
            jj = j
            for k in _lane_cols(w0, lane):
                if k >= d:
                    break
                while lo[jj + 1] <= k:
                    jj += 1
                cols[k] = coff[jj] + (k - lo[jj]) // CHUNK
    return vec, [cols[k] for k in range(d)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dequant_blocks_and_scale_columns_match_brute_force(layout):
    _, leaves = LAYOUTS[layout]
    dims = [D for _, _, D in leaves]
    lo = uplink._leaf_starts([0] + [sum(dims[:i + 1])
                                    for i in range(len(dims))])
    d = lo[-1]
    want = [c for *_, c in _enumerate(leaves, False)]
    vec, cols = _blocks(lo, d)
    # the lanes' columns cover the group once, each with its scale column
    assert cols == want
    assert cols == compress.chunk_cols(torch.tensor(lo), 0, d).tolist()
    for b, quads in enumerate(vec):
        w0 = b * BLOCK
        span = range(w0, min(w0 + BLOCK, d))
        leaf = {bisect.bisect_right(lo[:-1], k) - 1 for k in span}
        one = (len(span) == BLOCK and len(leaf) == 1
               and lo[min(leaf)] % 4 == 0)
        # the 16-byte path takes exactly the full blocks inside one leaf
        # that starts on the 4-column grid, in a group of d % 4 == 0, where
        # each quad's 4 columns share the one scale column it reads
        assert (quads is not None) == (one and d % 4 == 0)
        if quads is not None:
            for lane in range(32):
                for q in range(4):
                    k = w0 + 128 * q + 4 * lane
                    assert set(want[k:k + 4]) == {quads[lane][q]}
    assert sum(q is not None for q in vec) == VECTOR_BLOCKS[layout]


def test_leaf_starts_are_host_integers():
    want = (0, 3, 300)
    for lo in (want, list(want), torch.tensor(want),
               torch.tensor(want, dtype=torch.int32)):
        got = uplink._leaf_starts(lo)
        assert got == want and all(type(v) is int for v in got)
    with pytest.raises(ValueError):
        uplink._leaf_starts(torch.empty(3, dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("lo", [(0, 5, 4, 9), (0, 8), (1, 9), (0, 4, 10),
                                (9,)])
def test_dequant_refuses_leaf_starts_that_do_not_cover_the_group(lo):
    codes = torch.zeros(2, 9, dtype=torch.int8)
    nc = sum(-(-(b - a) // CHUNK) for a, b in zip(lo, lo[1:]))
    scales = torch.ones(2, max(nc, 1))
    slot = torch.tensor([0, 1], dtype=torch.int32)
    band = torch.zeros(9, dtype=torch.int32)
    with pytest.raises(ValueError):
        uplink.masked_sum_dequant(codes, scales, lo, slot, band, 2, 1)


def test_device_table_is_made_once_per_values_and_device():
    a = _build.device_table((0, 7, 300), torch.device("cpu"))
    b = _build.device_table((0, 7, 300), torch.device("cpu"))
    assert a is b and a.dtype == torch.int64 and a.tolist() == [0, 7, 300]
    assert _build.device_table((0, 7), torch.device("cpu")) is not a


def test_wire_plan_keeps_leaf_starts_on_the_host():
    dims = (300, 70001, 50, 3, 4096)
    band = comm_ws.cyclic_band(dims, 3, 2, "cpu")
    plan = comm_ws.wire_plan(dims, "auto", 3, 2, band)
    by_kind = {g.kind: g for g in plan}
    assert by_kind["int8"].leaf_lo == (0, 70001)
    assert by_kind["f16"].leaf_lo == (0, 300, 350, 353, 4449)
    for g in plan:
        assert all(type(v) is int for v in g.leaf_lo)
