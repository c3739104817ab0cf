"""The comm step's per-client wire counters against the reference's f32
accumulation.

The reference keeps ``up_floats``, ``down_floats``, ``up_bytes`` and
``down_bytes`` as f32 scalars: each round's totals are ``jnp.float32`` of
the exact sums, a faulted round scales the uplink by ``surv_f32 / c`` (an
f32 division), and the totals are added in f32
(``repro.dist.tamuna_dp.make_comm_step``'s ``bump`` and ``up_arrived``).
Past 2^24 those sums round, so at the full-width row of 745,558,272 floats
the counts drift from the exact integers after a few rounds; the port must
drift the same way.  The reference's additions run here eagerly in
``jnp.float32``, in its order, and the port's counters must equal them
bitwise after every round.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import masks as jmasks
from repro.dist import wire as jwire
from repro_torch.configs import gemma2_2b
from repro_torch.dist import comm_ws, model_api, tamuna_dp, wire

KEYS = ("up_floats", "down_floats", "up_bytes", "down_bytes")


def _dims(cfg):
    return comm_ws.workspace_spec(model_api.param_specs(cfg)).dims


class _Reference:
    """The reference's counters: builder-time f32 totals, then f32 adds."""

    def __init__(self, dims, c, s, policy, wire_down):
        nnzs = [jmasks.column_nnz(D, c, s) for D in dims]
        kinds = [jwire.resolve_kind(D, policy) for D in dims]
        self.c = c
        self.up_total = jnp.float32(sum(nnzs))
        self.down_total = jnp.float32(sum(dims))
        self.up_bytes_total = jnp.float32(sum(
            jwire.leaf_up_bytes(nnz, D, 1, k)
            for nnz, D, k in zip(nnzs, dims, kinds)))
        self.down_bytes_total = jnp.float32(sum(
            jwire.leaf_down_bytes(D, k if wire_down else "f32")
            for D, k in zip(dims, kinds)))
        zero = jnp.zeros((), jnp.float32)
        self.state = dict.fromkeys(KEYS, zero)

    def bump(self, survivors=None):
        up, upb = None, None
        if survivors is not None:
            frac = jnp.asarray(survivors, jnp.int32).astype(jnp.float32) \
                / self.c
            up, upb = self.up_total * frac, self.up_bytes_total * frac
        st = self.state
        st["up_floats"] = st["up_floats"] + (self.up_total if up is None
                                             else up)
        st["down_floats"] = st["down_floats"] + self.down_total
        st["up_bytes"] = st["up_bytes"] + (self.up_bytes_total if upb is None
                                           else upb)
        st["down_bytes"] = st["down_bytes"] + self.down_bytes_total


def _bits(v):
    return np.asarray(v, np.float32).view(np.uint32).item()


@pytest.mark.parametrize("policy,wire_down,c,s,survivors", [
    ("f32", False, 3, 2, None),  # [train]
    ("f32", False, 4, 3, 3),  # [faults]: 3 of the 4 members arrived
    ("auto", True, 3, 2, None),  # [wire]
    ("int8", False, 4, 3, 3),  # [wire_faults]
])
def test_counters_match_reference_f32_over_20_rounds_at_full_width(
        policy, wire_down, c, s, survivors):
    """20 rounds at the chip paths' full-width row (gemma2-2b's leaves at
    two layers, d_total 745,558,272), from the leaf dims alone: no
    workspace is allocated."""
    cfg = dataclasses.replace(gemma2_2b.CONFIG, n_layers=2)
    dims = _dims(cfg)
    assert sum(dims) == 745_558_272
    kinds = [wire.resolve_kind(D, policy) for D in dims]
    totals = tamuna_dp.comm_counters(dims, c, s, kinds, wire_down)
    ref = _Reference(dims, c, s, policy, wire_down)
    assert [_bits(v) for v in totals] == [_bits(v) for v in (
        ref.up_total, ref.down_total, ref.up_bytes_total,
        ref.down_bytes_total)]
    state = tamuna_dp.DistTamunaState(x=None, h=None, spec=None)
    for r in range(20):
        tamuna_dp.add_counters(state, totals, c, survivors)
        ref.bump(survivors)
        for k in KEYS:
            got = getattr(state, k)
            assert isinstance(got, np.float32), k
            assert _bits(got) == _bits(ref.state[k]), (r, k)
    # the f32 sums have drifted from the exact counts
    assert float(state.down_floats) != 20 * sum(dims)


def test_comm_steps_count_in_f32_as_the_reference():
    """Three comm steps of the reduced config on the CPU, the second with
    a dropped member (2 of 3 arrived: the uplink scaled by 2/3 in f32),
    their counters bitwise the reference's f32 adds."""
    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34,
                                      wire_precision="int8")
    state = tamuna_dp.init_state(cfg, tcfg, 4, seed=0, device="cpu")
    comm = tamuna_dp.make_comm_step(cfg, tcfg, 4, device="cpu")
    ref = _Reference(_dims(cfg), 3, 2, "int8", False)
    for arrived in (None, np.array([True, False, True, True]), None):
        state = comm(state, [0, 1, 3], [1, 2, 0], arrived=arrived,
                     wire_seed=5)
        ref.bump(None if arrived is None else int(arrived[[0, 1, 3]].sum()))
        for k in KEYS:
            assert _bits(getattr(state, k)) == _bits(ref.state[k]), k
