"""The port's plain comm implementations (``comm_ws.cyclic_comm_leaves``,
``impl="ws"`` and ``impl="dense"``) and the convex bench driver against the
reference (``repro.dist.comm_ws.cyclic_comm``, ``benchmarks/faults_bench``
and the convergence half of ``benchmarks/quant_comm_bench``), on seeded
numpy inputs:

* the leaf tables bitwise, and the kernel-convention ownership
  ``_wrapped_owned`` against ``owned_from_band``;
* each impl against the reference's same impl, bitwise (dense at s = 3
  within 2**-20 of the largest value: its sum over every row adds the
  owners in another order than XLA's reduction), with f32 storage
  (in this process) and f64 storage (jax x64 in a subprocess): fault free,
  dropped members with the survivor rebuild and with the wait-all
  ``1/s``, DownCom rows, a tall leaf (``D s < c``), s = 3, a dict of
  leaves, and the f16 and int8 wire with ``wire_down`` at the reference's
  wire seed.  The reference runs un-jitted: under ``jax.jit`` XLA:CPU
  turns a division by a constant (``/ s``, the scales' ``/ 127``) into a
  multiplication by its reciprocal, one rounding away from the division
  eager JAX and the port compute (ROADMAP.md C);
* ws against dense in the port: bitwise at s = 2 but for the sign of
  zeros, within the same 2**-20 at s = 3;
* an impl other than ws and dense is refused (the kernel path is
  ``cyclic_comm``); ``robust=`` is held in ``tests/test_torch_reputation.py``;
* the driver at ``--smoke`` size against the reference benches' smoke
  mode (``REPRO_BENCH_SMOKE=1``, run as the benches run them, jitted):
  equal rounds to target, retries and quorum misses, and the fingerprints
  and suboptimalities within 1e-6.  The local steps run in f64 in both,
  but the gradients sum in other orders (and XLA may contract into FMAs),
  so a last f64 bit can move the comm step's f32 rounding by one ulp
  (6e-8 relative), which the rounds carry.  The quant rows take the
  reference's threefry wire seeds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import comm_ws as jcomm
from repro.dist import wire as jwire
from repro_torch.dist import comm_ws
from repro_torch.kernels import compress
from repro_torch.launch import convex_bench

SCALE = 0.37


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wseed(k):
    return int(jwire.round_seed(jax.random.fold_in(jax.random.key(k),
                                                   jwire.WIRE_FOLD)))


# name -> (n, leaf shapes, c, s, faulted, correct, down, wire, wire_down);
# one leaf is passed as a tensor, several as a dict
CASES = {
    "clean": (8, [(300,)], 4, 2, False, True, False, None, False),
    "survivor_down": (8, [(300,)], 4, 2, True, True, True, None, False),
    "wait_all": (8, [(300,)], 4, 2, True, False, True, None, False),
    "s3_survivor": (9, [(301,)], 6, 3, True, True, False, None, False),
    "s3_clean": (9, [(301,)], 6, 3, False, True, True, None, False),
    "tall": (12, [(3,)], 10, 2, False, True, True, None, False),
    "tall_faulted": (12, [(3,)], 10, 2, True, True, True, None, False),
    "dict": (8, [(5, 7), (3,), (40,)], 6, 2, True, True, True, None, False),
    "f16_down": (8, [(600,)], 4, 2, True, True, True, "f16", True),
    "int8_down": (8, [(600,)], 4, 2, False, True, True, "int8", True),
    "int8_dict": (8, [(9, 70), (3,)], 6, 2, True, True, False, "int8",
                  True),
}
SEED_OF = {name: 11 + i for i, name in enumerate(CASES)}
# f64 storage: the cases whose f32 round trip differs (every rebuild, the
# DownCom gates and the wire)
F64_CASES = ("clean", "wait_all", "tall_faulted", "dict", "int8_down",
             "f16_down")


def _case_inputs(name, dtype):
    n, shapes, c, s, faulted, _, down, _, _ = CASES[name]
    rng = np.random.default_rng(SEED_OF[name])
    xs = [rng.normal(size=(n,) + sh).astype(dtype) for sh in shapes]
    hs = [rng.normal(size=(n,) + sh).astype(dtype) for sh in shapes]
    slot = np.full(n, -1, np.int32)
    slot[rng.choice(n, size=c, replace=False)] = rng.permutation(c)
    arrived = rng.random(n) < 0.7 if faulted else None
    dn = rng.random(n) < 0.5 if down else None
    return xs, hs, slot, arrived, dn


def _keys(k):
    return [f"leaf{j}" for j in range(k)]


def _port(name, impl, dtype):
    n, shapes, c, s, _, correct, _, wire, wire_down = CASES[name]
    xs, hs, slot, arrived, dn = _case_inputs(name, dtype)

    def tree(arrs):
        ts = [torch.from_numpy(a.copy()) for a in arrs]
        return ts[0] if len(ts) == 1 else dict(zip(_keys(len(ts)), ts))

    x, h = comm_ws.cyclic_comm_leaves(
        tree(xs), tree(hs), torch.from_numpy(slot), c, s, SCALE, impl=impl,
        down=None if dn is None else torch.from_numpy(dn),
        arrived=None if arrived is None else torch.from_numpy(arrived),
        correct=correct, wire=wire, wire_seed=_wseed(SEED_OF[name]),
        wire_down=wire_down)
    flat = (lambda t: [t] if isinstance(t, torch.Tensor)
            else [t[k] for k in _keys(len(shapes))])
    return [a.numpy() for a in flat(x)], [a.numpy() for a in flat(h)]


# the reference's side, run eagerly (in the subprocess below with x64)
def reference(name, impl, dtype):
    n, shapes, c, s, faulted, correct, down, wire, wire_down = CASES[name]
    xs, hs, slot, arrived, dn = _case_inputs(name, dtype)

    def tree(arrs):
        ts = [jnp.asarray(a) for a in arrs]
        return ts[0] if len(ts) == 1 else dict(zip(_keys(len(ts)), ts))

    x, h = jcomm.cyclic_comm(
        tree(xs), tree(hs), jnp.asarray(slot), c, s, SCALE, impl=impl,
        down=None if dn is None else jnp.asarray(dn),
        arrived=None if arrived is None else jnp.asarray(arrived),
        correct=correct, wire=wire,
        wire_seed=jnp.uint32(_wseed(SEED_OF[name])) if wire else None,
        wire_down=wire_down)
    flat = (lambda t: [t] if not isinstance(t, dict)
            else [t[k] for k in _keys(len(shapes))])
    return ([np.asarray(a) for a in flat(x)],
            [np.asarray(a) for a in flat(h)])


def _assert_same(a, b, impl, s):
    """Bitwise, but for dense at s >= 3: its masked sum over every row adds
    the s owners in another order than XLA's reduction (within 8 f32 ulps
    of the largest payload, 2**-20 of max(1, |value|))."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if impl == "dense" and s >= 3:
        tol = 2.0 ** -20 * max(1.0, float(np.nanmax(np.abs(b))))
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.nanmax(np.abs(a - b)) <= tol
    else:
        assert a.tobytes() == b.tobytes(), float(np.nanmax(np.abs(a - b)))


def test_leaf_tables_and_ownership_match_the_reference():
    for D, c, s in ((300, 4, 2), (301, 6, 3), (3, 10, 2), (7, 7, 7),
                    (20958, 100, 2)):
        for got, want in zip(comm_ws._cyclic_leaf_tables_np(D, c, s),
                             jcomm._cyclic_leaf_tables_np(D, c, s)):
            assert np.array_equal(got, want)
            assert np.asarray(got).dtype == np.asarray(want).dtype
        band = compress.cyclic_band(torch.arange(D), c, s)
        slots = torch.arange(-2, c + 2)[:, None]
        inr = (slots >= 0) & (slots < c)
        got = comm_ws._wrapped_owned(slots.clamp(0, c - 1), band, c, s) & inr
        want = compress.owned_from_band(slots, band, c, s)
        assert torch.equal(got, want)
        ref = jcomm._wrapped_owned(
            jax.numpy.asarray(slots.clamp(0, c - 1).numpy()),
            jax.numpy.asarray(band.numpy()), c, s)
        assert np.array_equal(np.asarray(ref) & inr.numpy(), got.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("impl", ["ws", "dense"])
def test_f32_storage_matches_the_reference(impl, name):
    gx, gh = _port(name, impl, np.float32)
    wx, wh = reference(name, impl, np.float32)
    for a, b in zip(gx + gh, wx + wh):
        _assert_same(a, b, impl, CASES[name][3])


@pytest.fixture(scope="module")
def f64_reference(subproc, tmp_path_factory):
    """The reference's outputs on f64 storage (x64 on), and its smoke
    benches, from one subprocess."""
    path = tmp_path_factory.mktemp("comm_impls") / "ref.npz"
    code = f'''
import contextlib, io, json, os
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.dist import comm_ws as jcomm
from repro.dist import wire as jwire
SCALE = {SCALE!r}
CASES = {CASES!r}
SEED_OF = {SEED_OF!r}
def _keys(k):
    return [f"leaf{{j}}" for j in range(k)]
def _wseed(k):
    return int(jwire.round_seed(jax.random.fold_in(jax.random.key(k),
                                                   jwire.WIRE_FOLD)))
''' + _source(_case_inputs) + _source(reference) + f'''
out = {{}}
for name in {F64_CASES!r}:
    for impl in ("ws", "dense"):
        xs, hs = reference(name, impl, np.float64)
        for j, (a, b) in enumerate(zip(xs, hs)):
            out[f"{{name}}/{{impl}}/x{{j}}"] = a
            out[f"{{name}}/{{impl}}/h{{j}}"] = b
np.savez({str(path)!r}, **out)

# the reference benches' smoke mode, as the benches run them
os.environ["REPRO_BENCH_SMOKE"] = "1"
from benchmarks import faults_bench, quant_comm_bench
res = {{}}
for key, src in (("faults", faults_bench._CODE),
                 ("quant", quant_comm_bench._CONV_CODE)):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        exec(src, {{"__name__": "bench"}})
    res[key] = json.loads(buf.getvalue().strip().splitlines()[-1])
print("BENCH " + json.dumps(res))
'''
    stdout = subproc(code, devices=1)
    line = [ln for ln in stdout.splitlines() if ln.startswith("BENCH ")][-1]
    return dict(np.load(path)), json.loads(line[len("BENCH "):])


def _source(fn):
    import inspect

    return inspect.getsource(fn)


@pytest.mark.parametrize("name", F64_CASES)
@pytest.mark.parametrize("impl", ["ws", "dense"])
def test_f64_storage_matches_the_reference(f64_reference, impl,
                                                   name):
    want, _ = f64_reference
    gx, gh = _port(name, impl, np.float64)
    for j, (a, b) in enumerate(zip(gx, gh)):
        assert a.dtype == np.float64 and b.dtype == np.float64
        _assert_same(a, want[f"{name}/{impl}/x{j}"], impl, CASES[name][3])
        _assert_same(b, want[f"{name}/{impl}/h{j}"], impl, CASES[name][3])
        # the comm step computes in f32: h holds f32 values
        assert np.array_equal(b.astype(np.float32).astype(np.float64), b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ws_equals_dense(name):
    s = CASES[name][3]
    wx, wh = _port(name, "ws", np.float32)
    dx, dh = _port(name, "dense", np.float32)
    for a, b in zip(wx + wh, dx + dh):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        if s == 2:  # equal values; only the sign of a zero may differ
            assert np.array_equal(a, b, equal_nan=True)
        else:  # the owners are added in other orders
            _assert_same(a, b, "dense", s)


def test_the_kernel_path_is_not_an_impl_of_the_plain_step():
    x = torch.zeros(4, 8)
    slot = torch.tensor([0, 1, 2, -1])
    with pytest.raises(ValueError, match="impl"):
        comm_ws.cyclic_comm_leaves(x, x.clone(), slot, 3, 2, 1.0,
                                   impl="pallas")


def _close(a, b, tol=1e-6):
    return abs(a - b) <= tol * max(1.0, abs(b))


def test_faults_driver_matches_the_reference_smoke_bench(f64_reference):
    _, ref = f64_reference
    want = ref["faults"]
    bench = convex_bench.ConvexBench.for_bench(True, "cpu")
    got = convex_bench.run_faults(bench)
    assert len(got["rows"]) == len(want["rows"])
    for g, w in zip(got["rows"], want["rows"]):
        for k in ("p_fail", "policy", "rounds_to_target", "retries",
                  "quorum_miss", "sim_clock"):
            assert g[k] == w[k], (k, g, w)
        assert _close(g["final_suboptimality"], w["final_suboptimality"])
        for a, b in zip(g["x_fingerprint"], w["x_fingerprint"]):
            assert abs(a - b) <= 1e-6, (g, w)
    for k in ("fault_free_rounds", "quorum_ratio_at_p02",
              "wait_all_control_stalls_at_p02", "deterministic_replay_ok"):
        assert got[k] == want[k], k
    assert got["config"] == {k: want["config"][k] for k in got["config"]}
    assert _close(got["target"], want["target"], 1e-12)


def test_quant_driver_matches_the_reference_smoke_bench(f64_reference):
    _, ref = f64_reference
    want = ref["quant"]
    bench = convex_bench.ConvexBench.for_bench(True, "cpu")
    seeds = [_wseed(g) for g in range(bench.size["quant_rounds"])]
    got = convex_bench.run_quant(bench, wire_seeds=seeds)
    assert got["matched_rounds"] == want["matched_rounds"]
    for g, w in zip(got["rows"], want["rows"]):
        for k in ("kind", "bits", "rounds", "rounds_to_target"):
            assert g[k] == w[k], (k, g, w)
        assert _close(g["floor"], w["floor"])
        assert _close(g["final_suboptimality"], w["final_suboptimality"])
    assert _close(got["floor_ratio_int8_vs_f32"],
                  want["floor_ratio_int8_vs_f32"])


def test_cli_writes_its_json_and_never_a_bench_file(tmp_path):
    out = tmp_path / "cb.json"
    assert convex_bench.main(["--smoke", "--device", "cpu", "--only",
                              "faults", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and "quant" not in res
    assert res["faults"]["fault_free_rounds"] is not None
    assert convex_bench.main(["--smoke", "--device", "cpu", "--out",
                              str(tmp_path / "BENCH_faults.json")]) == 2
    assert not (tmp_path / "BENCH_faults.json").exists()


def test_quant_driver_reproduces_bench_quant_comm_with_its_seeds():
    """The convergence half of BENCH_quant_comm.json at full size on the
    CPU, with the reference's threefry wire seeds: the rounds equal, the
    floors within 1e-5 relative (the bench ran jitted, where the scales'
    ``/ 127`` is a multiplication by the reciprocal: a code may land one
    level apart)."""
    import os

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "BENCH_quant_comm.json")) as f:
        want = json.load(f)["convergence"]
    bench = convex_bench.ConvexBench.for_bench(False, "cpu")
    seeds = [_wseed(g) for g in range(want["matched_rounds"])]
    got = convex_bench.run_quant(bench, wire_seeds=seeds)
    assert got["matched_rounds"] == want["matched_rounds"]
    for g, w in zip(got["rows"], want["rows"]):
        for k in ("kind", "rounds", "rounds_to_target"):
            assert g[k] == w[k], (k, g, w)
        assert _close(g["floor"], w["floor"], 1e-5), (g, w)
    assert _close(got["floor_ratio_int8_vs_f32"],
                  want["floor_ratio_int8_vs_f32"], 1e-5)
