"""The port's Byzantine-robust round against the reference (``repro.dist``):

* ``normalize_robust`` and ``DistTamunaConfig.robust_`` give the
  reference's specs and raise where it raises;
* the plain ``robust_sum`` against the Pallas kernel in interpret mode on a
  ragged width, trimmed (k=1) and median at s=3 and s=4, with tied owner
  values, owned +inf and -inf payloads and NaN in dropped and idle rows,
  and at s = 1, 2, 8 and 16 with n = s + 2 rows, all-+inf columns, an
  owned NaN and bands outside [0, m) (the CUDA kernel's scalar path):
  bitwise (both take the same order statistics, and the combine repeats
  the body's operations in order);
* ``adversarial_rows`` (every mode), ``payload_norms`` and
  ``magnitude_outliers`` on the workspace against the reference's tree
  versions (the inlier mean and the norms to 1e-5 relative: the reference
  reduces in another order);
* the robust comm step against ``repro.dist.comm_ws.cyclic_comm(
  impl="pallas")`` on a multi-leaf tree, with and without the survivor
  correction (2e-6 absolute);
* one faulted round of reduced gemma2-2b (n=5, c=4, s=3, one local step,
  a dropped member holding NaN) against the reference's per-step
  composition, for the mean and the trimmed mean (1e-5 absolute, as
  ``tests/test_torch_round.py``: the two frameworks' gradients differ in
  the last bits, and the h update multiplies x's differences by
  eta/gamma = 5.7; measured 3.5e-6);
* the training CLI with a trimmed combiner and a sign-flipping adversary
  on the CPU.
"""

import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import gemma2_2b as jgemma
from repro.dist import comm_ws as jcomm
from repro.dist import faults as jfaults
from repro.dist import model_api as japi
from repro.dist import robust as jrobust
from repro.dist import tamuna_dp as jtd
from repro.kernels import uplink as juplink
from repro_torch.configs import gemma2_2b
from repro_torch.dist import comm_ws, faults, model_api, robust, tamuna_dp
from repro_torch.kernels import uplink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind,k,s", [
    ("mean", 0, 3), ("trimmed", 0, 3), ("trimmed", 1, 3), ("trimmed", 1, 4),
    ("median", 0, 2), ("mean", 1, 3), ("trimmed", 2, 4), ("median", 1, 3),
    ("mode", 0, 3), ("trimmed", -1, 3)])
def test_normalize_robust_matches_reference(kind, k, s):
    try:
        want = jrobust.normalize_robust(kind, k, s)
    except ValueError:
        with pytest.raises(ValueError):
            robust.normalize_robust(kind, k, s)
        with pytest.raises(ValueError):
            tamuna_dp.DistTamunaConfig(gamma=0.1, c=4, s=s, p=0.5,
                                       robust_agg=kind, trim_k=k)
        return
    assert robust.normalize_robust(kind, k, s) == want
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.1, c=4, s=s, p=0.5,
                                      robust_agg=kind, trim_k=k)
    assert tcfg.robust_() == want


D, M = 3 * 4096 + 77, 4


def _robust_edge_inputs(s):
    """n = s + 2 rows over m = s + 2 template columns, D % 4 != 0: s
    active rows, row 1 dropped and the last row idle (both NaN); ties,
    +-inf, an owned NaN, columns whose every entry is +inf, and bands
    outside [0, m), both negative and >= m (the kernel's scalar path)."""
    rng = np.random.default_rng(100 + s)
    n = m = s + 2
    cols = rng.permutation(m)[:s].tolist()
    slot = np.array([cols[0], -1] + cols[1:] + [-1], np.int32)
    x = rng.normal(size=(n, D)).astype(np.float32)
    x[1] = x[-1] = np.nan
    act = [i for i in range(n) if slot[i] >= 0]
    x[act[-1], ::7] = x[act[0], ::7]  # tied owner values
    x[act[0], ::101] = np.inf
    x[act[-1], 50::101] = -np.inf
    x[act[0], 9::157] = np.nan  # an owned NaN
    x[np.ix_(act, np.arange(3, D, 211))] = np.inf
    band = rng.integers(0, m, size=(D,)).astype(np.int32)
    band[::97] = -3
    band[5::89] = m + 3
    band[7::101] = -m - 1
    return x, slot, band, m


@pytest.mark.parametrize("kind,k,s,edges", [
    pytest.param("trimmed", 1, 3, False, id="trimmed-1-3"),
    pytest.param("trimmed", 1, 4, False, id="trimmed-1-4"),
    pytest.param("median", 0, 3, False, id="median-0-3"),
    pytest.param("median", 0, 4, False, id="median-0-4"),
    *[pytest.param(kind, k, s, True, id=f"edges-{kind}-{k}-{s}")
      for s in (1, 2, 8, 16)
      for kind, k in (("trimmed", (s - 1) // 2), ("median", 0))],
])
def test_robust_sum_matches_pallas_interpret_bitwise(kind, k, s, edges):
    m = M
    if edges:
        x, slot, band, m = _robust_edge_inputs(s)
    else:
        rng = np.random.default_rng(s)
        # rows 1 (dropped) and 5 (idle) own nothing and hold NaN
        slot = np.array([2, -1, 0, 3, 1, -1], np.int32)
        x = rng.normal(size=(len(slot), D)).astype(np.float32)
        x[1] = x[5] = np.nan
        x[2, ::7] = x[0, ::7]  # tied owner values: the tie rule
        x[4, 3::11] = x[3, 3::11]
        x[0, ::101] = np.inf
        x[3, 50::101] = -np.inf
        x[4, ::303] = np.inf
        band = rng.integers(0, M, size=(D,)).astype(np.int32)
    bar_w, cnt_w = juplink.robust_sum(
        jnp.asarray(x), jnp.asarray(slot), jnp.asarray(band), m, s,
        kind=kind, k=k, interpret=True)
    bar, cnt = uplink.robust_sum(torch.from_numpy(x), torch.from_numpy(slot),
                                 torch.from_numpy(band), m, s, kind=kind,
                                 k=k)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_w))
    bar_w = np.asarray(bar_w)
    assert np.isinf(bar.numpy()).any()
    assert np.isnan(bar.numpy()).any() or not edges
    np.testing.assert_array_equal(np.isnan(bar.numpy()), np.isnan(bar_w))
    live = ~np.isnan(bar_w)
    assert bar.numpy()[live].tobytes() == bar_w[live].tobytes()


def test_robust_sum_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(3, 8)
    slot = torch.zeros(3, dtype=torch.int32)
    band = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        uplink.robust_sum(x, slot, band, 4, 3, kind="mode")
    with pytest.raises(ValueError):
        uplink.robust_sum(x, slot, band, 4, 3, kind="trimmed", k=2)
    with pytest.raises(ValueError):
        uplink.robust_sum(x.double(), slot, band, 4, 3, kind="median")


def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 7, 9)).astype(np.float32),
            "b": rng.normal(size=(n, 50)).astype(np.float32),
            "c": rng.normal(size=(n, 3)).astype(np.float32)}


def _ws(tree):
    """The tree packed leaf by leaf (``jax.tree.leaves`` order) into an
    ``(n, d)`` workspace."""
    n = tree["a"].shape[0]
    return np.concatenate([np.asarray(tree[k]).reshape(n, -1)
                           for k in sorted(tree)], axis=1)


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["sign_flip", "scale", "inlier"])
def test_adversarial_rows_match_reference(mode):
    n = 7
    tree = _tree(n, 3)
    byz = np.array([0, 1, 0, 0, 0, 1, 0], bool)
    honest = np.array([1, 1, 1, 0, 1, 0, 1], bool)
    want = _ws(jfaults.adversarial_rows(_jtree(tree), jnp.asarray(byz),
                                        jnp.asarray(honest), mode))
    ws = torch.from_numpy(_ws(tree))
    faults.adversarial_rows(ws, byz, honest, mode)
    got = ws.numpy()
    assert got[~byz].tobytes() == _ws(tree)[~byz].tobytes()
    if mode == "inlier":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert got.tobytes() == want.tobytes()


def test_magnitude_guard_matches_reference():
    n = 8
    tree = _tree(n, 4)
    tree["b"][2] *= 1e4  # a finite blowup
    tree["a"][5, 0, 0] = np.nan  # a nonfinite row: norm inf
    mask = np.array([1, 1, 1, 0, 1, 1, 1, 1], bool)
    ws = torch.from_numpy(_ws(tree))
    want_norms = np.asarray(jrobust.payload_norms(_jtree(tree)))
    got_norms = robust.payload_norms(ws).numpy()
    np.testing.assert_allclose(got_norms, want_norms, rtol=1e-5)
    want = np.asarray(jrobust.magnitude_outliers(_jtree(tree),
                                                 jnp.asarray(mask)))
    got = robust.magnitude_outliers(ws, mask)
    np.testing.assert_array_equal(got, want)
    assert got[2] and got[5] and got.sum() == 2
    np.testing.assert_allclose(
        float(robust.masked_median(torch.from_numpy(want_norms.copy()),
                                   mask)),
        float(jrobust.masked_median(jnp.asarray(want_norms),
                                    jnp.asarray(mask))), rtol=1e-7)


@pytest.mark.parametrize("spec", [("trimmed", 1), ("median", 0)])
@pytest.mark.parametrize("correct", [True, False])
def test_robust_comm_matches_reference_pallas(spec, correct):
    n, c, s = 8, 5, 3
    tree, htree = _tree(n, 1), _tree(n, 11)
    rng = np.random.default_rng(2)
    ids = np.sort(rng.choice(n, c, replace=False))
    slot = np.full(n, -1, np.int32)
    slot[ids] = rng.permutation(c)
    arrived = rng.random(n) < 0.7
    arrived[ids[0]] = False
    for k in tree:  # a dropped member may hold anything
        tree[k][ids[0]] = np.nan
    tree["b"][ids[1]] *= -10.0  # an arrived outlier
    down = np.zeros(n, bool)
    down[ids[1:]] = True
    want = jcomm.cyclic_comm(
        _jtree(tree), _jtree(htree), jnp.asarray(slot), c, s, 0.5,
        impl="pallas", down=jnp.asarray(down), arrived=jnp.asarray(arrived),
        correct=correct, robust=spec)
    ws, hs = torch.from_numpy(_ws(tree)), torch.from_numpy(_ws(htree))
    dims = [int(np.prod(tree[k].shape[1:])) for k in sorted(tree)]
    band = comm_ws.cyclic_band(dims, c, s, "cpu")
    comm_ws.cyclic_comm(ws, hs, torch.from_numpy(slot), band, c, s, 0.5,
                        down=torch.from_numpy(down).to(torch.int32),
                        arrived=torch.from_numpy(arrived), correct=correct,
                        robust=spec)
    for got, w in ((ws.numpy(), want[0]), (hs.numpy(), want[1])):
        w = _ws(w)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(w))
        np.testing.assert_allclose(got, w, atol=2e-6)


N, C, S, L = 5, 4, 3, 1
SEQ, BATCH = 16, 2
COHORT = [0, 1, 3, 4]
ARRIVED = np.array([True, False, False, True, True])  # member 1 dropped
DOWN = np.array([True, True, True, False, True])


@pytest.fixture(scope="module")
def reference():
    jcfg = jgemma.REDUCED
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = japi.init(jax.random.key(0), jcfg)
    names, leaves, treedef = checkpoint._flatten_with_names(params)
    rng = np.random.default_rng(7)
    x0 = [np.asarray(a)[None] + 0.01 * rng.normal(
        size=(N,) + a.shape).astype(np.float32) for a in leaves]
    h0 = [0.01 * rng.normal(size=(N,) + a.shape).astype(np.float32)
          for a in leaves]
    h0 = [(a - a.mean(axis=0, keepdims=True)).astype(np.float32)
          for a in h0]
    toks = rng.integers(0, jcfg.vocab, size=(L, C, BATCH, SEQ + 1))
    key = jax.random.key_data(jax.random.key(11))
    _, k_perm = jax.random.split(jax.random.wrap_key_data(key))
    perm = np.asarray(jax.random.permutation(k_perm, C))
    tcfg = jtd.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34)
    return dict(
        jcfg=jcfg, mesh=mesh, names=names, treedef=treedef, x0=x0, h0=h0,
        toks=toks.astype(np.int32), key=key, perm=perm,
        local=jax.jit(jtd.make_local_step(jcfg, tcfg)),
    )


def _run_reference(ref, robust_agg, trim_k):
    tcfg = jtd.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34,
                                robust_agg=robust_agg, trim_k=trim_k)
    comm = jax.jit(jtd.make_comm_step(ref["jcfg"], tcfg, ref["mesh"],
                                      impl="ws", n=N),
                   static_argnames=("correct",))
    unflat = lambda ls: jax.tree.unflatten(ref["treedef"],
                                           [jnp.asarray(a) for a in ls])
    zero = jnp.zeros((), jnp.float32)
    state = jtd.DistTamunaState(
        x=unflat(ref["x0"]), h=unflat(ref["h0"]), opt=(),
        round=jnp.zeros((), jnp.int32), up_floats=zero, down_floats=zero,
        up_bytes=zero, down_bytes=zero)
    cohort = jnp.asarray(COHORT, jnp.int32)
    compact = jtd.gather_cohort(state, cohort)
    for t in range(L):
        tk = jnp.asarray(ref["toks"][t])
        compact, _ = ref["local"](compact, tokens=tk[..., :-1],
                                  labels=tk[..., 1:])
    state = jtd.scatter_cohort(state, compact, cohort)
    # the dropped member's payload is garbage
    state = state._replace(x=jax.tree.map(lambda a: a.at[1].set(jnp.nan),
                                          state.x))
    return comm(state, ref["key"], cohort=cohort, down=jnp.asarray(DOWN),
                arrived=jnp.asarray(ARRIVED), correct=True)


def _run_port(ref, robust_agg, trim_k):
    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34,
                                      robust_agg=robust_agg, trim_k=trim_k)
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    x = torch.empty(N, spec.d_total)
    h = torch.empty(N, spec.d_total)
    comm_ws.pack({n: torch.from_numpy(a) for n, a in
                  zip(ref["names"], ref["x0"])}, spec, x)
    comm_ws.pack({n: torch.from_numpy(a) for n, a in
                  zip(ref["names"], ref["h0"])}, spec, h)
    state = tamuna_dp.DistTamunaState(x=x, h=h, spec=spec)
    local = tamuna_dp.make_local_step(cfg, tcfg)
    compact = tamuna_dp.gather_cohort(state, COHORT)
    for t in range(L):
        tk = torch.from_numpy(ref["toks"][t]).long()
        local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
    state = tamuna_dp.scatter_cohort(state, compact)
    state.x[1] = float("nan")
    comm = tamuna_dp.make_comm_step(cfg, tcfg, N, device="cpu")
    return comm(state, COHORT, ref["perm"].tolist(), torch.from_numpy(DOWN),
                arrived=ARRIVED, correct=True)


@pytest.mark.parametrize("robust_agg,trim_k", [("mean", 0), ("trimmed", 1)])
def test_faulted_round_matches_reference_per_step_composition(
        reference, robust_agg, trim_k):
    want = _run_reference(reference, robust_agg, trim_k)
    got = _run_port(reference, robust_agg, trim_k)
    gx = comm_ws.unpack(got.x, got.spec)
    gh = comm_ws.unpack(got.h, got.spec)
    for name, wx, wh in zip(reference["names"], jax.tree.leaves(want.x),
                            jax.tree.leaves(want.h)):
        wx, wh = np.asarray(wx), np.asarray(wh)
        live = ~np.isnan(wx)
        assert np.array_equal(np.isnan(gx[name].numpy()), ~live), name
        assert np.abs(gx[name].numpy()[live] - wx[live]).max() <= 1e-5, name
        assert np.abs(gh[name].numpy() - wh).max() <= 1e-5, name
    # the dropped member's h is untouched; the idle row's x and h too
    h0f = np.concatenate([a.reshape(N, -1) for a in reference["h0"]], axis=1)
    assert got.h[1].numpy().tobytes() == h0f[1].tobytes()
    assert got.h[2].numpy().tobytes() == h0f[2].tobytes()
    for k in ("up_floats", "down_floats", "up_bytes", "down_bytes"):
        w = float(getattr(want, k))
        assert abs(getattr(got, k) - w) <= 1e-5 * w, k
    # three of the four members arrived
    assert got.up_floats < float(want.down_floats)


def test_train_cli_robust_adversary_runs_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    args = ["--reduced", "--rounds", "2", "--sparsity", "3",
            "--robust-agg", "trimmed", "--trim-k", "1",
            "--adversary", "sign_flip", "--f-byz", "0.25", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"final loss (\S+)$", proc.stdout.strip())
    assert m and math.isfinite(float(m.group(1))), proc.stdout
    assert "arrivals=" in proc.stderr
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--reputation"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert rep.returncode != 0 and "not ported yet" in rep.stderr
