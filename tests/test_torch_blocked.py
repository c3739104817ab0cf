"""The blocked template (``uplink="block_rs"``) and the tall-and-thin
fallback of the port against the reference.

* the block band (``comm_ws.block_band``) against ``_block_band_np``,
  ragged last chunks included;
* ``blocked_comm`` in the port's three forms (the kernel path's plain
  versions through ``block_uplink.block_rs_aggregate(impl="pallas")``,
  ``blocked_comm_leaves(impl="ws"|"dense")``) against the reference's
  ``comm_ws.blocked_comm(impl="ws"|"dense")``, jitted, on leaves of
  ragged sizes (one shorter than c) at c < n, an idle row of NaN: the
  mean, survivor, wait-all, trimmed, median and int8-wire (``wire_down``,
  a drop) rounds; the kernel path and ws against the reference's ws (they
  select by ownership), dense against its dense (it multiplies by the
  mask, so the idle NaN row reaches a fault-free round's x_bar in both).
  Within 2**-20 of the largest value (the dense form sums the masked
  ``(n, D)`` payload in another order at s = 3; jitted, XLA rounds the
  int wire's scales otherwise than the reference run eagerly, which moves
  this round's x_bar by 2.4e-7 and no code by a level), bitwise in the
  s = 2 mean round;
* ``block_rs_aggregate`` at full participation against the reference's
  ``_leaf_aggregate`` and the port's own;
* the ``block_rs`` comm step's four counters against the reference's
  ``make_comm_step(uplink="block_rs")`` on a 1-layer model of width 16 and
  the ``auto`` wire, bitwise, with its x and h within 1e-5;
* the tall-and-thin leaves (``D s < c``): a 1-layer model of width 16 at
  n = c = 40, s = 2 (its norm leaves, D = 16, are tall) and a bare
  two-leaf case, the kernel path (tall leaves laid last, the kernels over
  the columns before them) and ``ws`` against the reference's
  ``cyclic_comm(impl="dense")``, within 2**-20.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.dist import block_uplink as jbu
from repro.dist import comm_ws as jcomm
from repro.dist import model_api as japi
from repro.dist import tamuna_dp as jtd
from repro.dist import wire as jwire
from repro_torch.configs import registry
from repro_torch.dist import block_uplink, comm_ws, model_api, tamuna_dp

N, C = 6, 4
DIMS = {"a": (37,), "b": (5, 13), "c": (3,)}
SCALE = 0.37
TOL = 2.0 ** -20
# a 1-layer model of width 16: its norm leaves (D = 16) are tall at c = 40
TINY = dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
            d_ff=32, vocab=64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_block_band_matches_reference():
    for dims, c in (((37, 65, 3, 7), 4), ((1, 100, 99), 7), ((12,), 12),
                    ((745, 5), 3)):
        got = comm_ws.block_band(list(dims), c, "cpu").numpy()
        want = jcomm._block_band_np(tuple(dims), c)
        assert got.dtype == np.int32 and np.array_equal(got, want)
        assert got.min() >= 0 and got.max() < c


def _leaves(seed):
    rng = np.random.default_rng(seed)
    x = {k: rng.normal(size=(N,) + s).astype(np.float32)
         for k, s in DIMS.items()}
    h = {k: 0.1 * rng.normal(size=(N,) + s).astype(np.float32)
         for k, s in DIMS.items()}
    return x, h


CASES = {
    "mean": dict(s=2),
    "survivor": dict(s=3, arrived=[1, 1, 0, 1, 1, 0]),
    "wait_all": dict(s=3, arrived=[1, 1, 0, 1, 1, 0], correct=False),
    "trimmed": dict(s=3, arrived=[1, 0, 1, 1, 1, 1],
                    robust=("trimmed", 1)),
    "median": dict(s=3, robust=("median", 0)),
    "int8": dict(s=2, arrived=[1, 1, 1, 0, 1, 1], wire="int8",
                 wire_down=True),
}
SLOT_OF = np.array([2, 0, -1, 3, 1, -1])  # clients 2 and 5 idle
DOWN = np.array([1, 1, 0, 1, 0, 1], bool)
OFF = 3


def _reference(case, impl, x, h):
    kw = CASES[case]
    jkw = dict(c=C, slot_of=jnp.asarray(SLOT_OF, jnp.int32),
               down=jnp.asarray(DOWN), correct=kw.get("correct", True),
               robust=kw.get("robust"))
    if "arrived" in kw:
        jkw["arrived"] = jnp.asarray(np.array(kw["arrived"], bool))
    if "wire" in kw:
        jkw.update(wire=kw["wire"], wire_seed=jnp.uint32(0xBEEF),
                   wire_down=kw["wire_down"])

    def run(jx, jh):
        return jcomm.blocked_comm(jx, jh, jnp.int32(OFF), N, kw["s"], SCALE,
                                  impl, **jkw)

    jx, jh = jax.jit(run)(
        {k: jnp.asarray(v) for k, v in x.items()},
        {k: jnp.asarray(v) for k, v in h.items()})
    return ({k: np.asarray(v) for k, v in jx.items()},
            {k: np.asarray(v) for k, v in jh.items()})


def _port(case, impl, x, h):
    kw = CASES[case]
    tkw = dict(c=C, slot_of=torch.from_numpy(SLOT_OF),
               down=torch.from_numpy(DOWN), correct=kw.get("correct", True),
               robust=kw.get("robust"))
    if "arrived" in kw:
        tkw["arrived"] = torch.tensor(kw["arrived"], dtype=torch.bool)
    if "wire" in kw:
        tkw.update(wire=kw["wire"], wire_seed=0xBEEF,
                   wire_down=kw["wire_down"])
    tx = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    th = {k: torch.from_numpy(v.copy()) for k, v in h.items()}
    tcfg = tamuna_dp.DistTamunaConfig(gamma=1.0, c=C, s=kw["s"], p=0.5)
    gx, gh = block_uplink.block_rs_aggregate(tx, th, OFF, N, tcfg, SCALE,
                                             impl=impl, **tkw)
    return ({k: v.numpy() for k, v in gx.items()},
            {k: v.numpy() for k, v in gh.items()})


@pytest.mark.parametrize("impl", ["pallas", "ws", "dense"])
@pytest.mark.parametrize("case", list(CASES))
def test_blocked_comm_matches_reference(case, impl):
    x, h = _leaves(11)
    if impl != "dense":
        # an idle row may hold anything: the kernel path and ws select by
        # ownership, as the reference's ws does (the dense form multiplies
        # by its mask, and its NaN handling on a fault-free round differs
        # between the reference run eagerly and jitted)
        x["b"][2] = np.nan
    got_x, got_h = _port(case, impl, x, h)
    for jimpl in (("dense",) if impl == "dense" else ("ws",)):
        want_x, want_h = _reference(case, jimpl, x, h)
        top = max(np.nanmax(np.abs(v)) for v in want_x.values())
        for k in DIMS:
            for got, want in ((got_x[k], want_x[k]), (got_h[k], want_h[k])):
                assert np.array_equal(np.isnan(got), np.isnan(want)), k
                live = ~np.isnan(want)
                err = np.abs(got[live] - want[live]).max(initial=0.0)
                assert err <= TOL * top, (case, impl, jimpl, k, err)
                if case == "mean" and jimpl == "ws":
                    assert np.array_equal(got[live], want[live]), k
    # rows outside the cohort keep h; rows outside the DownCom keep x
    for k in DIMS:
        for i in np.flatnonzero(SLOT_OF < 0):
            assert got_h[k][i].tobytes() == h[k][i].tobytes()
        for i in np.flatnonzero(~DOWN):
            assert np.array_equal(got_x[k][i], x[k][i], equal_nan=True)


def test_block_rs_aggregate_matches_leaf_aggregate():
    """Full participation (c = n, identity slots): the reference's and the
    port's prior path ``_leaf_aggregate`` against every impl."""
    x, h = _leaves(12)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=1.0, c=N, s=2, p=0.5)
    for off in (0, 4):
        for k in DIMS:
            jx, jh = jbu._leaf_aggregate(jnp.asarray(x[k]), jnp.asarray(h[k]),
                                         jnp.int32(off), N, 2, SCALE)
            px, ph = block_uplink._leaf_aggregate(
                torch.from_numpy(x[k]), torch.from_numpy(h[k]), off, N, 2,
                SCALE)
            assert np.array_equal(px.numpy(), np.asarray(jx)), k
            assert np.abs(ph.numpy() - np.asarray(jh)).max() <= 1e-7, k
        for impl in ("pallas", "ws", "dense"):
            gx, gh = block_uplink.block_rs_aggregate(
                {k: torch.from_numpy(v.copy()) for k, v in x.items()},
                {k: torch.from_numpy(v.copy()) for k, v in h.items()}, off,
                N, tcfg, SCALE, impl=impl)
            for k in DIMS:
                px, ph = block_uplink._leaf_aggregate(
                    torch.from_numpy(x[k]), torch.from_numpy(h[k]), off, N,
                    2, SCALE)
                assert np.array_equal(gx[k].numpy(), px.numpy()), (impl, k)
                assert np.abs(gh[k].numpy() - ph.numpy()).max() <= 1e-7


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def test_block_rs_comm_step_counters_and_values_match_reference():
    """Two ``block_rs`` comm steps of a 1-layer model of width 16 on the
    int8 wire with the DownCom quantized (the norm leaves as f16 lanes
    under ``auto``): the counters bitwise, x and h within 1e-5 (the comm
    step alone, so the round tolerance of the local step does not
    enter)."""
    n, c, s = 4, 3, 2
    jcfg = dataclasses.replace(jregistry.get_reduced_config("gemma2-2b"),
                               **TINY)
    cfg = dataclasses.replace(registry.get_reduced_config("gemma2-2b"),
                              **TINY)
    kw = dict(gamma=0.05, c=c, s=s, p=0.34, uplink="block_rs",
              wire_precision="auto", wire_down=True)
    jt = jtd.DistTamunaConfig(comm_impl="ws", **kw)
    params = japi.init(jax.random.key(0), jcfg)
    names, leaves, treedef = jckpt._flatten_with_names(params)
    rng = np.random.default_rng(3)
    x0 = [np.asarray(a)[None] + 0.01 * rng.normal(size=(n,) + a.shape)
          .astype(np.float32) for a in leaves]
    h0 = [0.01 * rng.normal(size=(n,) + a.shape).astype(np.float32)
          for a in leaves]
    unflat = lambda ls: jax.tree.unflatten(  # noqa: E731
        treedef, [jnp.asarray(a) for a in ls])
    zero = jnp.zeros((), jnp.float32)
    jstate = jtd.DistTamunaState(
        x=unflat(x0), h=unflat(h0), opt=(), round=jnp.zeros((), jnp.int32),
        up_floats=zero, down_floats=zero, up_bytes=zero, down_bytes=zero)
    jcomm_step = jax.jit(jtd.make_comm_step(jcfg, jt, _mesh(), n=n))
    tcfg = tamuna_dp.DistTamunaConfig(**kw)
    spec = tamuna_dp.state_spec(cfg, tcfg)
    assert list(spec.names) == names
    xw, hw = torch.empty(n, spec.d_total), torch.empty(n, spec.d_total)
    comm_ws.pack({k: torch.from_numpy(a) for k, a in zip(names, x0)}, spec,
                 xw)
    comm_ws.pack({k: torch.from_numpy(a) for k, a in zip(names, h0)}, spec,
                 hw)
    state = tamuna_dp.DistTamunaState(x=xw, h=hw, spec=spec)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device="cpu")
    for r, cohort in enumerate(([0, 2, 3], [1, 2, 3])):
        key = jax.random.key_data(jax.random.key(20 + r))
        _, k_off = jax.random.split(jax.random.wrap_key_data(key))
        off = int(jax.random.randint(k_off, (), 0, c, jnp.int32))
        down = np.array([True, True, False, True])
        jstate = jcomm_step(jstate, key, cohort=jnp.asarray(cohort,
                                                            jnp.int32),
                            down=jnp.asarray(down))
        seed = int(jwire.round_seed(jax.random.fold_in(
            jax.random.wrap_key_data(key), jwire.WIRE_FOLD)))
        state = comm(state, cohort, down=torch.from_numpy(down),
                     wire_seed=seed, off=off)
        for k in ("up_floats", "down_floats", "up_bytes", "down_bytes"):
            assert getattr(state, k).tobytes() == np.asarray(
                getattr(jstate, k)).tobytes(), (r, k)
    gx, gh = comm_ws.unpack(state.x, spec), comm_ws.unpack(state.h, spec)
    for k, wx, wh in zip(names, jax.tree.leaves(jstate.x),
                         jax.tree.leaves(jstate.h)):
        assert np.abs(gx[k].numpy() - np.asarray(wx)).max() <= 1e-5, k
        assert np.abs(gh[k].numpy() - np.asarray(wh)).max() <= 1e-5, k


# --------------------------------------------------------------------------
# tall-and-thin leaves
# --------------------------------------------------------------------------

def _tall_inputs(names_shapes, n, seed):
    rng = np.random.default_rng(seed)
    x = {k: rng.normal(size=(n,) + tuple(s)).astype(np.float32)
         for k, s in names_shapes}
    h = {k: 0.1 * rng.normal(size=(n,) + tuple(s)).astype(np.float32)
         for k, s in names_shapes}
    return x, h


def _reference_dense(x, h, slot, c, s, down, **kw):
    def run(jx, jh):
        return jcomm.cyclic_comm(jx, jh, jnp.asarray(slot, jnp.int32), c, s,
                                 SCALE, "dense", down=jnp.asarray(down), **kw)

    jx, jh = jax.jit(run)(
        {k: jnp.asarray(v) for k, v in x.items()},
        {k: jnp.asarray(v) for k, v in h.items()})
    return ({k: np.asarray(v) for k, v in jx.items()},
            {k: np.asarray(v) for k, v in jh.items()})


@pytest.mark.parametrize("impl", ["auto", "ws"])
@pytest.mark.parametrize("fault", [False, True])
def test_tall_leaves_of_a_tiny_model_match_reference_dense(impl, fault):
    """n = c = 40, s = 2: the norm leaves (D = 16, D s = 32 < 40) are tall
    and laid last; the kernels take the other leaves."""
    n = c = 40
    s = 2
    cfg = dataclasses.replace(registry.get_reduced_config("gemma2-2b"),
                              **TINY)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=1.0, c=c, s=s, p=0.5,
                                      eta=SCALE, comm_impl=impl)
    spec = tamuna_dp.state_spec(cfg, tcfg)
    specs = model_api.param_specs(cfg)
    tall = [nm for nm, shp in specs
            if int(np.prod(shp)) * s < c]
    assert tall and list(spec.names[-len(tall):]) == tall
    assert spec.d_main == spec.offsets[spec.n_main]
    x, h = _tall_inputs(specs, n, 5)
    rng = np.random.default_rng(6)
    perm = rng.permutation(c)
    down = rng.random(n) < 0.7
    kw = {}
    if fault:
        arrived = rng.random(n) < 0.8
        kw = dict(arrived=arrived)
    want_x, want_h = _reference_dense(
        x, h, perm, c, s, down,
        **({} if not fault else {"arrived": jnp.asarray(kw["arrived"])}))
    xw, hw = torch.empty(n, spec.d_total), torch.empty(n, spec.d_total)
    comm_ws.pack({k: torch.from_numpy(v) for k, v in x.items()}, spec, xw)
    comm_ws.pack({k: torch.from_numpy(v) for k, v in h.items()}, spec, hw)
    state = tamuna_dp.DistTamunaState(x=xw, h=hw, spec=spec)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, n, device="cpu")
    comm(state, np.arange(n), perm.tolist(), torch.from_numpy(down), **kw)
    gx, gh = comm_ws.unpack(state.x, spec), comm_ws.unpack(state.h, spec)
    top = max(np.abs(v).max() for v in want_x.values())
    for k in want_x:
        for got, want in ((gx[k].numpy(), want_x[k]),
                          (gh[k].numpy(), want_h[k])):
            assert np.abs(got - want).max() <= TOL * top, k


def test_tall_and_wide_leaf_pair_matches_reference_dense():
    """A bare workspace of one wide leaf (the kernels) and one tall leaf
    after it (the fallback), with a drop and the int8 wire."""
    n, c, s = N, N, 2
    x, h = _tall_inputs([("a_wide", (5, 13)), ("b_tall", (2,))], n, 7)
    slot = np.array([3, 5, 0, 2, 1, 4])
    down = np.array([1, 1, 0, 1, 1, 1], bool)
    arrived = np.array([1, 1, 1, 0, 1, 1], bool)
    want_x, want_h = _reference_dense(
        x, h, slot, c, s, down, arrived=jnp.asarray(arrived),
        wire="int8", wire_seed=jnp.uint32(77), wire_down=True)
    spec = comm_ws.workspace_spec([("a_wide", (5, 13)), ("b_tall", (2,))],
                                  last={"b_tall"})
    xw, hw = torch.empty(n, spec.d_total), torch.empty(n, spec.d_total)
    comm_ws.pack({k: torch.from_numpy(v) for k, v in x.items()}, spec, xw)
    comm_ws.pack({k: torch.from_numpy(v) for k, v in h.items()}, spec, hw)
    band = comm_ws.cyclic_band([65], c, s, "cpu")
    plan = comm_ws.wire_plan([65], "int8", c, s, band)
    comm_ws.cyclic_comm(
        xw, hw, torch.from_numpy(slot.astype(np.int32)), band, c, s, SCALE,
        down=torch.from_numpy(down.astype(np.int32)),
        arrived=torch.from_numpy(arrived), wire=plan, wire_seed=77,
        wire_down=True, tall=((1, 65, 2, "int8"),))
    gx, gh = comm_ws.unpack(xw, spec), comm_ws.unpack(hw, spec)
    top = max(np.abs(v).max() for v in want_x.values())
    for k in want_x:
        for got, want in ((gx[k].numpy(), want_x[k]),
                          (gh[k].numpy(), want_h[k])):
            assert np.abs(got - want).max() <= TOL * top, k
