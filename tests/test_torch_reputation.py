"""The rest of the port's robust layer against the reference
(``repro.dist.robust``, ``repro.dist.comm_ws``, ``repro.dist.faults``):

* ``robust_combine_stack`` bitwise in every branch: the static window of
  ``ok=None``, the sort-free path of ``trimmed`` k=1 and of medians of at
  most 4 rows (with 1e8, +-inf, tied and signed-zero entries), the
  network at m = 5, 12 and 16, all at partial counts including cnt = 0;
  at m = 40 (the sort, static and masked) the median bitwise and the
  trimmed mean within f32 reassociation (XLA's reduce over the window
  adds in another order, ROADMAP.md C);
* ``cyclic_comm_leaves(robust=)`` against ``cyclic_comm(impl="ws"|"dense",
  meshed=False, robust=)``: trimmed and median, fault-free, survivor and
  wait-all, a tall leaf, the int8 wire, f32 storage here and f64 storage
  under jax x64 in a subprocess; bitwise (dense at s >= 3 within the
  2**-20 already recorded); ``trimmed`` k=0 is the mean bitwise in ws,
  dense and the kernel path;
* ``anomaly_scores`` within 1e-6 relative over several leaves with
  nonfinite entries, in column chunks; ``Reputation``'s windows and
  ``state_dict`` bitwise over a fed sequence; ``recenter_h`` bitwise on
  f64 at n = 16;
* the f64 repairs: ``payload_norms``/``magnitude_outliers`` and
  ``adversarial_rows`` (every mode) compute in f32 on f64 storage, as the
  reference does;
* three rounds of reduced gemma2-2b through ``run_rounds(reputation=)``
  (n=5, c=4, s=3, a sign-flipping client, trimmed k=1) against the
  reference's per-step composition fed the same batches and
  permutations: the quarantine windows equal, the anomaly maxima within
  1e-5 relative;
* ``convex_bench --only robust`` at full size on the CPU against
  BENCH_robust.json's counts (fingerprints within 1e-6 relative).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import gemma2_2b as jgemma
from repro.dist import cohort as jcohort
from repro.dist import comm_ws as jcomm
from repro.dist import faults as jfaults
from repro.dist import model_api as japi
from repro.dist import robust as jrobust
from repro.dist import tamuna_dp as jtd
from repro_torch.configs import gemma2_2b
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import (cohort, comm_ws, faults, model_api, robust,
                              rounds, tamuna_dp)
from repro_torch.kernels import ref as kref
from repro_torch.launch import convex_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- robust_combine_stack -----------------------------------------------------

def _stack_inputs(m, special, ok_p, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(m, 777)).astype(np.float32)
    if special:
        v[0, ::5] = 1e8
        v[-1, 3::7] = -np.inf
        v[1 % m, 2::11] = np.inf
        v[-1, 8::23] = -1e8
        v[:, 4::13] = v[0, 4::13]  # ties across every row
        v[0, 6::17], v[-1, 6::17] = -0.0, 0.0
    ok = None
    if ok_p is not None:
        ok = rng.random((m, 777)) < ok_p
        ok[:, ::19] = False  # cnt = 0 columns
        ok[:, 1::19] = True
    return v, ok


STACK_CASES = (
    [("static", m, kind, k) for m in (3, 5, 12, 16)
     for kind, k in (("trimmed", 1), ("median", 0))]
    + [("static", 40, "median", 0), ("static", 40, "trimmed", 13)]
    + [("fast", m, "trimmed", 1) for m in (2, 3, 4, 5)]
    + [("fast", m, "median", 0) for m in (2, 3, 4)]
    + [("network", m, kind, k) for m in (5, 12, 16)
       for kind, k in (("trimmed", m // 4), ("median", 0))]
    + [("sort", 40, "median", 0), ("sort", 40, "trimmed", 13)])


@pytest.mark.parametrize("branch,m,kind,k", STACK_CASES,
                         ids=[f"{b}-{m}-{kd}-{k}"
                              for b, m, kd, k in STACK_CASES])
@pytest.mark.parametrize("special", [False, True])
def test_robust_combine_stack_matches_reference(branch, m, kind, k,
                                                special):
    ok_p = None if branch == "static" else 0.7
    v, ok = _stack_inputs(m, special, ok_p, seed=m * 7 + k)
    want, wcnt = jrobust.robust_combine_stack(
        jnp.asarray(v), None if ok is None else jnp.asarray(ok), kind, k)
    got, gcnt = robust.robust_combine_stack(
        torch.from_numpy(v), None if ok is None else torch.from_numpy(ok),
        kind, k)
    want = np.asarray(want)
    assert gcnt.dtype == torch.int32
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))
    if ok is not None:
        assert (gcnt.numpy() == 0).any() and (got.numpy()[::19] == 0).all()
    got = got.numpy()
    if m > 32 and kind == "trimmed":
        # XLA sums the sorted window in another order than torch
        fin = np.isfinite(want)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.array_equal(got[~fin], want[~fin], equal_nan=True)
        tol = 2.0 ** -20 * max(1.0, float(np.abs(want[fin]).max()))
        assert np.abs(got[fin] - want[fin]).max() <= tol
    else:
        assert got.tobytes() == want.tobytes()


def test_robust_combine_stack_rejects_unknown_kinds():
    with pytest.raises(ValueError):
        robust.robust_combine_stack(torch.zeros(3, 4), None, "mean", 0)
    assert robust._oem_pairs(5) == jrobust._oem_pairs(5)
    assert robust._oem_pairs(32) == jrobust._oem_pairs(32)


# -- the plain comm implementations with robust= -----------------------------

# name -> (n, leaf shapes, c, s, faulted, correct, wire)
COMM_CASES = {
    "clean": (9, [(301,), (5, 7)], 6, 3, False, True, None),
    "survivor": (9, [(301,), (5, 7)], 6, 3, True, True, None),
    "wait_all": (9, [(301,), (5, 7)], 6, 3, True, False, None),
    "tall": (12, [(3,)], 10, 3, False, True, None),
    "tall_survivor": (12, [(3,)], 10, 3, True, True, None),
    "s5": (8, [(200,)], 7, 5, True, True, None),
    "int8": (9, [(600,), (3, 40)], 6, 3, True, True, "int8"),
}
SPECS = {"trimmed": ("trimmed", 1), "median": ("median", 0)}
F64_COMM = ("clean", "survivor")


def _comm_inputs(name, dtype):
    n, shapes, c, s, faulted, _, _ = COMM_CASES[name]
    rng = np.random.default_rng(len(name) * 31 + n)
    xs = [rng.normal(size=(n,) + sh).astype(dtype) for sh in shapes]
    hs = [rng.normal(size=(n,) + sh).astype(dtype) for sh in shapes]
    xs[0][:, ::3] *= 1e3  # an outlying band
    slot = np.full(n, -1, np.int32)
    slot[rng.choice(n, c, replace=False)] = rng.permutation(c)
    arrived = rng.random(n) < 0.7 if faulted else None
    return xs, hs, slot, arrived


def _wire_seed(name):
    return 1234567 + len(name)


def _port_comm(name, impl, spec, dtype):
    n, shapes, c, s, _, correct, wire = COMM_CASES[name]
    xs, hs, slot, arrived = _comm_inputs(name, dtype)
    tree = lambda a: {f"l{j}": torch.from_numpy(v.copy())  # noqa: E731
                      for j, v in enumerate(a)}
    x, h = comm_ws.cyclic_comm_leaves(
        tree(xs), tree(hs), torch.from_numpy(slot), c, s, 0.37, impl=impl,
        arrived=None if arrived is None else torch.from_numpy(arrived),
        correct=correct, robust=spec, wire=wire,
        wire_seed=_wire_seed(name))
    return ([x[f"l{j}"].numpy() for j in range(len(xs))]
            + [h[f"l{j}"].numpy() for j in range(len(xs))])


def reference_comm(name, impl, spec, dtype):
    n, shapes, c, s, _, correct, wire = COMM_CASES[name]
    xs, hs, slot, arrived = _comm_inputs(name, dtype)
    tree = lambda a: {f"l{j}": jnp.asarray(v)  # noqa: E731
                      for j, v in enumerate(a)}
    x, h = jcomm.cyclic_comm(
        tree(xs), tree(hs), jnp.asarray(slot), c, s, 0.37, impl=impl,
        arrived=None if arrived is None else jnp.asarray(arrived),
        correct=correct, robust=spec, wire=wire,
        wire_seed=jnp.uint32(_wire_seed(name)) if wire else None)
    return ([np.asarray(x[f"l{j}"]) for j in range(len(xs))]
            + [np.asarray(h[f"l{j}"]) for j in range(len(xs))])


def _assert_same(a, b, impl, s):
    assert a.dtype == b.dtype and a.shape == b.shape
    if impl == "dense" and s >= 3:
        tol = 2.0 ** -20 * max(1.0, float(np.nanmax(np.abs(b))))
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.nanmax(np.abs(a - b)) <= tol
    else:
        assert a.tobytes() == b.tobytes(), float(np.nanmax(np.abs(a - b)))


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("impl", ["ws", "dense"])
@pytest.mark.parametrize("name", sorted(COMM_CASES))
def test_robust_comm_f32_matches_reference(name, impl, spec):
    got = _port_comm(name, impl, SPECS[spec], np.float32)
    want = reference_comm(name, impl, SPECS[spec], np.float32)
    for a, b in zip(got, want):
        _assert_same(a, b, impl, COMM_CASES[name][3])


@pytest.mark.parametrize("impl", ["ws", "dense"])
def test_trimmed_k0_is_the_mean_bitwise(impl):
    """``trimmed`` with k = 0 normalizes to ``None``: the mean path, bitwise
    in ws, dense and the kernel path, fault-free and survivor."""
    spec0 = robust.normalize_robust("trimmed", 0, 3)
    assert spec0 is None
    for name in ("clean", "survivor"):
        xs, hs, slot, arrived = _comm_inputs(name, np.float32)
        n, _, c, s, _, _, _ = COMM_CASES[name]
        kw = {} if arrived is None else {"arrived": torch.from_numpy(
            arrived)}
        a = comm_ws.cyclic_comm_leaves(
            torch.from_numpy(xs[0]), torch.from_numpy(hs[0]),
            torch.from_numpy(slot), c, s, 0.37, impl=impl, **kw)
        b = comm_ws.cyclic_comm_leaves(
            torch.from_numpy(xs[0]), torch.from_numpy(hs[0]),
            torch.from_numpy(slot), c, s, 0.37, impl=impl, robust=spec0,
            **kw)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        band = comm_ws.cyclic_band([xs[0].shape[1]], c, s, "cpu")
        outs = []
        for sp in (None, spec0):
            xw, hw = torch.from_numpy(xs[0].copy()), torch.from_numpy(
                hs[0].copy())
            comm_ws.cyclic_comm(xw, hw, torch.from_numpy(slot), band, c, s,
                                0.37, robust=sp, **kw)
            outs.append((xw, hw))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])


# -- anomaly scores and reputation --------------------------------------------

def _tree(n, seed):
    rng = np.random.default_rng(seed)
    t = {"a": rng.normal(size=(n, 7, 9)).astype(np.float32),
         "b": rng.normal(size=(n, 50)).astype(np.float32),
         "c": rng.normal(size=(n, 3)).astype(np.float32)}
    t["b"][0] *= -3.0  # an outlier
    t["a"][1, 2, ::2] = np.nan
    t["b"][2, 7] = np.inf
    return t


def _ws(tree):
    n = tree["a"].shape[0]
    return np.concatenate([np.asarray(tree[k]).reshape(n, -1)
                           for k in sorted(tree)], axis=1)


@pytest.mark.parametrize("n,mask", [
    (4, [1, 1, 1, 1]), (4, [1, 0, 1, 1]), (5, [1, 1, 1, 1, 1]),
    (8, [1, 1, 0, 1, 1, 1, 0, 1]), (8, [0] * 8), (3, [0, 1, 0])])
@pytest.mark.parametrize("chunk", [None, 37])
def test_anomaly_scores_match_reference(monkeypatch, n, mask, chunk):
    if chunk is not None:  # several column chunks, straddling leaves
        monkeypatch.setattr(kref, "CHUNK", chunk)
    tree = _tree(n, n)
    mask = np.asarray(mask, bool)
    want = np.asarray(jrobust.anomaly_scores(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(mask)))
    got = robust.anomaly_scores(torch.from_numpy(_ws(tree)), mask)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got[~mask], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_reputation_replays_the_reference():
    rng = np.random.default_rng(5)
    kw = dict(alpha=0.4, threshold=2.5, base_rounds=3, max_doublings=2)
    a, b = jrobust.Reputation(6, **kw), robust.Reputation(6, **kw)
    for r in range(60):
        anom = rng.gamma(1.0, 1.0, size=6).astype(np.float32)
        anom[r % 6] *= 8.0
        arrived = rng.random(6) < 0.75
        assert a.update(anom, arrived) == b.update(anom, arrived)
        if r == 30:  # a restored copy goes on identically
            b = robust.Reputation.from_state_dict(
                json.loads(json.dumps(b.state_dict())))
    assert a.state_dict() == b.state_dict()
    assert int(b.strikes.sum()) > 3
    with pytest.raises(ValueError):
        robust.Reputation(3, threshold=1.0)
    with pytest.raises(ValueError):
        robust.Reputation(3, alpha=0.0)


# -- float64 storage, under jax x64 in a subprocess --------------------------

@pytest.fixture(scope="module")
def f64_reference(subproc, tmp_path_factory):
    path = tmp_path_factory.mktemp("reputation") / "ref.npz"
    code = f'''
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.dist import comm_ws as jcomm
from repro.dist import faults as jfaults
from repro.dist import robust as jrobust
COMM_CASES = {COMM_CASES!r}
''' + _source(_comm_inputs) + _source(_wire_seed) + _source(
        reference_comm) + f'''
out = {{}}
for name in {F64_COMM!r}:
    for impl in ("ws", "dense"):
        for spec in ({tuple(SPECS.values())!r}):
            for j, a in enumerate(reference_comm(name, impl, spec,
                                                 np.float64)):
                out[f"comm/{{name}}/{{impl}}/{{spec[0]}}/{{j}}"] = a
rng = np.random.default_rng(9)
tree = {{"a": rng.normal(size=(7, 5, 6)), "b": rng.normal(size=(7, 33))}}
tree["b"][3] *= 1e4
tree["a"][5, 1, 2] = np.nan
byz = np.array([0, 1, 0, 0, 0, 1, 0], bool)
honest = np.array([1, 1, 1, 0, 1, 0, 1], bool)
mask = np.array([1, 1, 1, 1, 0, 1, 1], bool)
jt = {{k: jnp.asarray(v) for k, v in tree.items()}}
for k, v in tree.items():
    out[f"tree/{{k}}"] = v
out["norms"] = np.asarray(jrobust.payload_norms(jt))
out["outliers"] = np.asarray(jrobust.magnitude_outliers(jt, jnp.asarray(mask)))
for mode in ("sign_flip", "scale", "inlier"):
    got = jfaults.adversarial_rows(jt, jnp.asarray(byz), jnp.asarray(honest), mode)
    for k in tree:
        out[f"adv/{{mode}}/{{k}}"] = np.asarray(got[k])
h = np.random.default_rng(10).normal(size=(16, 32))
active = np.random.default_rng(11).random(16) < 0.6
out["h"], out["active"] = h, active
out["recenter"] = np.asarray(jrobust.recenter_h(jnp.asarray(h), jnp.asarray(active)))
np.savez({str(path)!r}, **out)
'''
    subproc(code, devices=1)
    return dict(np.load(path))


def _source(fn):
    import inspect

    return inspect.getsource(fn)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("impl", ["ws", "dense"])
@pytest.mark.parametrize("name", F64_COMM)
def test_robust_comm_f64_storage_matches_reference(f64_reference, name,
                                                   impl, spec):
    got = _port_comm(name, impl, SPECS[spec], np.float64)
    for j, a in enumerate(got):
        b = f64_reference[f"comm/{name}/{impl}/{spec}/{j}"]
        assert a.dtype == np.float64
        _assert_same(a, b, impl, COMM_CASES[name][3])
    # the comm step computes in f32 whatever the storage type: h (the
    # second half) holds f32 values
    for a in got[len(got) // 2:]:
        assert np.array_equal(a.astype(np.float32).astype(np.float64), a,
                              equal_nan=True)


def _f64_ws(ref):
    return np.concatenate([ref["tree/a"].reshape(7, -1), ref["tree/b"]],
                          axis=1)


def test_f64_guard_computes_in_f32(f64_reference):
    ref = f64_reference
    ws = torch.from_numpy(_f64_ws(ref))
    mask = np.array([1, 1, 1, 1, 0, 1, 1], bool)
    norms = robust.payload_norms(ws)
    assert norms.dtype == torch.float32
    np.testing.assert_allclose(norms.numpy(), ref["norms"], rtol=1e-5)
    np.testing.assert_array_equal(robust.magnitude_outliers(ws, mask),
                                  ref["outliers"])


@pytest.mark.parametrize("mode", ["sign_flip", "scale", "inlier"])
def test_f64_adversarial_rows_compute_in_f32(f64_reference, mode):
    ref = f64_reference
    byz = np.array([0, 1, 0, 0, 0, 1, 0], bool)
    honest = np.array([1, 1, 1, 0, 1, 0, 1], bool)
    ws = torch.from_numpy(_f64_ws(ref))
    before = ws.clone()
    faults.adversarial_rows(ws, byz, honest, mode)
    want = np.concatenate([ref[f"adv/{mode}/a"].reshape(7, -1),
                           ref[f"adv/{mode}/b"]], axis=1)
    got = ws.numpy()
    assert got[~byz].tobytes() == before.numpy()[~byz].tobytes()
    # the Byzantine rows hold f32 values
    assert np.array_equal(got[byz].astype(np.float32).astype(np.float64),
                          got[byz], equal_nan=True)
    if mode == "inlier":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert got.tobytes() == want.tobytes()


def test_recenter_h_f64_bitwise(f64_reference):
    ref = f64_reference
    h = torch.from_numpy(ref["h"])
    got = robust.recenter_h(h, ref["active"])
    assert got.dtype == torch.float64
    assert got.numpy().tobytes() == ref["recenter"].tobytes()
    assert torch.equal(got[~torch.from_numpy(ref["active"])],
                       h[~torch.from_numpy(ref["active"])])
    assert float(got[torch.from_numpy(ref["active"])].sum(0).abs().max()) \
        < 1e-12


# -- run_rounds(reputation=) on reduced gemma2-2b --------------------------

N, C, S, R = 5, 4, 3, 3
SEQ, BATCH = 16, 2


def _plans():
    return (dict(seed=0, n=N, c=C),
            dict(seed=0, n=N, adversary="sign_flip", f_byz=0.2))


@pytest.fixture(scope="module")
def reputation_runs():
    """The port's ``run_rounds(reputation=True)`` and the reference's
    per-step composition of the same rounds, fed the same batches and
    permutations (one local step per round)."""
    jcfg, cfg = jgemma.REDUCED, gemma2_2b.REDUCED
    params = japi.init(jax.random.key(0), jcfg)
    names, leaves, treedef = checkpoint._flatten_with_names(params)
    rng = np.random.default_rng(7)
    x0 = [np.asarray(a)[None] + 0.01 * rng.normal(
        size=(N,) + a.shape).astype(np.float32) for a in leaves]
    h0 = [0.01 * rng.normal(size=(N,) + a.shape).astype(np.float32)
          for a in leaves]
    h0 = [(a - a.mean(axis=0, keepdims=True)).astype(np.float32)
          for a in h0]
    dcfg = DataConfig(seq_len=SEQ, per_client_batch=BATCH, vocab=512,
                      seed=0, n_clients=N)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34,
                                      robust_agg="trimmed", trim_k=1)

    # the port
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    x = torch.empty(N, spec.d_total)
    h = torch.empty(N, spec.d_total)
    comm_ws.pack({nm: torch.from_numpy(a) for nm, a in zip(names, x0)},
                 spec, x)
    comm_ws.pack({nm: torch.from_numpy(a) for nm, a in zip(names, h0)},
                 spec, h)
    state = tamuna_dp.DistTamunaState(x=x, h=h, spec=spec)
    pkw, fkw = _plans()
    plan = cohort.CohortPlan(**pkw)
    rep = robust.Reputation(N)
    _, rows = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=SyntheticTokenPipeline(dcfg, cfg,
                                                               "cpu"),
        rounds=R, rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=1, plan=plan,
        faults=faults.FaultPlan(**fkw), policy="quorum", reputation=rep)

    # the reference, step by step, with the port's draws
    gen = torch.Generator().manual_seed(1)
    perms = [torch.randperm(C, generator=gen).tolist() for _ in range(R)]
    pipe = SyntheticTokenPipeline(dcfg, cfg, "cpu")
    jtcfg = jtd.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34,
                                 robust_agg="trimmed", trim_k=1)
    scale = tcfg.eta_(N) / tcfg.gamma
    local = jax.jit(jtd.make_local_step(jcfg, jtcfg))
    anomaly = jax.jit(jrobust.anomaly_scores)
    outliers = jax.jit(jrobust.magnitude_outliers)
    comm = jax.jit(lambda x, h, slot, down, arr: jcomm.cyclic_comm(
        x, h, slot, C, S, scale, impl="ws", down=down, arrived=arr,
        correct=True, robust=("trimmed", 1)))
    jplan = jcohort.CohortPlan(**pkw)
    jf = jfaults.FaultPlan(**fkw)
    jrep = jrobust.Reputation(N)
    unflat = lambda ls: jax.tree.unflatten(  # noqa: E731
        treedef, [jnp.asarray(a) for a in ls])
    zero = jnp.zeros((), jnp.float32)
    st = jtd.DistTamunaState(
        x=unflat(x0), h=unflat(h0), opt=(), round=jnp.zeros((), jnp.int32),
        up_floats=zero, down_floats=zero, up_bytes=zero, down_bytes=zero)
    byz = jf.byzantine
    anom_max = []
    for g in range(R):
        coh = np.asarray(jplan.cohort(g))
        nxt = jplan.member_mask(g + 1)
        member = np.zeros(N, bool)
        member[coh] = True
        compact = jtd.gather_cohort(st, jnp.asarray(coh, jnp.int32))
        batch = pipe.sample_batch(coh)
        compact, _ = local(compact,
                           tokens=jnp.asarray(batch["tokens"].numpy()),
                           labels=jnp.asarray(batch["labels"].numpy()))
        st = jtd.scatter_cohort(st, compact, jnp.asarray(coh, jnp.int32))
        arr = member & ~jf.drops(g)
        xt = jfaults.adversarial_rows(st.x, jnp.asarray(byz & arr),
                                      jnp.asarray(arr & ~byz), "sign_flip")
        bad = np.asarray(jfaults.nonfinite_clients(xt, None)) & member
        bad |= np.asarray(outliers(xt, jnp.asarray(arr & ~bad))) & member
        arr &= ~bad
        xt = jax.tree.map(lambda a: jnp.where(
            jnp.asarray(bad).reshape((N,) + (1,) * (a.ndim - 1)),
            jnp.zeros((), a.dtype), a), xt)
        anom = np.asarray(anomaly(xt, jnp.asarray(arr)))
        anom_max.append(float(anom.max()))
        slot = np.full(N, -1, np.int32)
        slot[coh] = perms[g]
        xn, hn = comm(xt, st.h, jnp.asarray(slot), jnp.asarray(nxt),
                      jnp.asarray(arr))
        st = st._replace(x=xn, h=hn)
        for cid, w in jrep.update(anom, (member & ~jf.drops(g)) & ~bad):
            jplan.quarantine([cid], g + 2, g + 1 + w)
    return dict(rows=rows, plan=plan, rep=rep, jplan=jplan, jrep=jrep,
                anom_max=anom_max, byz=byz)


def test_reputation_rounds_match_reference(reputation_runs):
    res = reputation_runs
    got = [r["anomaly_max"] for r in res["rows"]]
    np.testing.assert_allclose(got, res["anom_max"], rtol=1e-5)
    windows = [(ids.tolist(), a, b) for ids, a, b in res["plan"]._quarantine]
    want = [(ids.tolist(), a, b) for ids, a, b in res["jplan"]._quarantine]
    assert windows == want
    # the sign-flipped client scores far above the honest ones and is
    # quarantined; no honest client is
    byz = np.flatnonzero(res["byz"]).tolist()
    assert windows and all(ids == byz for ids, _, _ in windows)
    assert max(got) > 10.0
    np.testing.assert_array_equal(res["rep"].strikes, res["jrep"].strikes)
    np.testing.assert_allclose(res["rep"].scores, res["jrep"].scores,
                               rtol=1e-5)


def test_run_rounds_reputation_needs_a_plan_and_faults():
    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.5)
    state = tamuna_dp.init_state(cfg, tcfg, 4, device="cpu")
    pipe = SyntheticTokenPipeline(DataConfig(seq_len=8, per_client_batch=1,
                                             vocab=64, n_clients=4), cfg,
                                  "cpu")
    kw = dict(cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=1,
              rng=np.random.default_rng(0), generator=torch.Generator())
    fp = faults.FaultPlan(seed=0, n=4, adversary="sign_flip", f_byz=0.25)
    with pytest.raises(ValueError, match="CohortPlan"):
        rounds.run_rounds(state, faults=fp, reputation=True, **kw)
    with pytest.raises(ValueError, match="CohortPlan"):
        rounds.run_rounds(state, plan=cohort.CohortPlan(0, 4, 3),
                          reputation=True, **kw)
    with pytest.raises(ValueError, match="covers 5"):
        rounds.run_rounds(state, plan=cohort.CohortPlan(0, 4, 3), faults=fp,
                          reputation=robust.Reputation(5), **kw)


# -- the robust convex bench --------------------------------------------------

def test_robust_bench_reproduces_bench_robust_on_cpu():
    """BENCH_robust.json's counts at full size on the CPU (the timed
    comm steps at a small width: they are reported, not compared)."""
    with open(os.path.join(REPO, "BENCH_robust.json")) as f:
        want = json.load(f)
    bench = convex_bench.ConvexBench.for_bench(False, "cpu")
    bench.size = {**bench.size, "time_d": 2048, "time_iters": 1}
    got = convex_bench.run_robust(bench)
    assert len(got["rows"]) == len(want["rows"])
    for g, w in zip(got["rows"], want["rows"]):
        for k in ("attack", "agg", "f_byz", "guard", "rounds_to_target",
                  "diverged", "guarded_rows", "quarantine_windows",
                  "quarantined_byz_only"):
            assert g[k] == w[k], (k, g, w)
        if w["x_fingerprint"] is None:
            assert g["x_fingerprint"] is None
        else:  # within 1e-6 of the fingerprint's largest entry
            gf, wf = np.array(g["x_fingerprint"]), np.array(
                w["x_fingerprint"])
            assert np.abs(gf - wf).max() <= 1e-6 * np.abs(wf).max(), (g, w)
    for k in ("fault_free_rounds", "ratios", "mean_control_stalls",
              "identity_bitwise_ok", "deterministic_replay_ok"):
        assert got[k] == want[k], k
    assert got["config"]["byzantine"] == want["config"]["byzantine"]
    assert {k: got["config"][k] for k in ("n", "d", "c", "s", "trim_k",
                                          "L")} == {
        k: want["config"][k] for k in ("n", "d", "c", "s", "trim_k", "L")}
    assert got["int8_wire_max_dev"] <= 0.25
    assert convex_bench.robust_accepted(got)


def test_convex_bench_cli_runs_the_robust_bench(tmp_path):
    out = tmp_path / "cb.json"
    assert convex_bench.main(["--smoke", "--device", "cpu", "--only",
                              "robust", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert "faults" not in res and res["robust"]["fault_free_rounds"]
    assert res["robust"]["config"]["s"] == res["robust"]["config"]["c"]
