"""The port's fault-tolerant round against the reference (``repro.dist``):

* ``FaultPlan``/``EmpiricalDelays``/``CohortPlan``/``MarkovAvailability``
  and the Byzantine set draw bitwise what the reference draws, over rounds
  and attempts, quarantine included; the host fault resolver agrees for
  every policy;
* the plain ``masked_sum(counts=True)`` and covered ``h_update`` against
  the Pallas kernels in interpret mode on a ragged width (the counts also
  at n = 1, 5 and 9 rows with bands outside [0, m); ``cnt`` exact,
  ``num`` to 1e-6 relative since the rows may be added in another order;
  the covered update bitwise, uncovered coordinates byte-identical);
* ``nonfinite_clients``/``corrupt_rows`` on the workspace against the
  reference's tree versions;
* the survivor comm step against ``repro.dist.comm_ws.cyclic_comm(
  impl="pallas")`` on a multi-leaf tree (2e-6 absolute, as the reference's
  own survivor tests), and an all-dropped round is a bitwise no-op;
* ``run_rounds``: a zero-fault plan is the fault-free run bitwise, and a
  faulted quorum run with NaN corruption and quarantine keeps finite losses
  and ``sum_i h_i = 0``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import cohort as jcohort
from repro.dist import comm_ws as jcomm
from repro.dist import faults as jfaults
from repro.dist import rounds as jrounds
from repro.kernels import uplink as juplink
from repro_torch.configs import gemma2_2b
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import cohort, comm_ws, faults, rounds, tamuna_dp
from repro_torch.kernels import uplink

MODELS = [
    dict(p_drop=0.3, p_corrupt=0.2, delay_sigma=0.4, straggler_frac=0.25),
    dict(p_drop=0.5, corrupt_mode="blowup", p_corrupt=0.5),
    dict(adversary="inlier", f_byz=0.3, p_drop=0.1),
]


@pytest.mark.parametrize("kw", MODELS)
def test_fault_plan_draws_bitwise_equal_reference(kw):
    want = jfaults.FaultPlan(seed=5, n=13, **kw)
    got = faults.FaultPlan(seed=5, n=13, **kw)
    assert got.is_zero == want.is_zero
    np.testing.assert_array_equal(got.byzantine, want.byzantine)
    np.testing.assert_array_equal(got.base_delays, want.base_delays)
    for rnd in range(6):
        for attempt in range(3):
            for name in ("drops", "corrupts", "delays"):
                np.testing.assert_array_equal(
                    getattr(got, name)(rnd, attempt),
                    getattr(want, name)(rnd, attempt), err_msg=name)
    assert faults.FaultPlan.zero(7).is_zero
    with pytest.raises(ValueError):
        faults.FaultModel(f_byz=0.2)


def test_empirical_delays_bitwise_equal_reference():
    samples = np.random.default_rng(3).lognormal(size=40)
    want = jfaults.EmpiricalDelays(samples, n=9, seed=4)
    got = faults.EmpiricalDelays(samples, n=9, seed=4)
    for rnd in range(5):
        for attempt in range(2):
            np.testing.assert_array_equal(got.delays(rnd, attempt),
                                          want.delays(rnd, attempt))
    np.testing.assert_array_equal(got.quantile([0.5, 0.9]),
                                  want.quantile([0.5, 0.9]))


@pytest.mark.parametrize("avail", [None, "bernoulli", "markov"])
def test_cohort_plan_attempts_and_quarantine_bitwise_equal_reference(avail):
    n, c = 11, 4

    def make(mod):
        a = None
        if avail == "bernoulli":
            a = mod.BernoulliAvailability(np.linspace(0.2, 0.9, n), seed=2)
        elif avail == "markov":
            a = mod.MarkovAvailability(0.3, 0.5, n=n, seed=2)
        return mod.CohortPlan(7, n, c, availability=a,
                              weights=np.arange(1, n + 1))

    want, got = make(jcohort), make(cohort)
    for rnd in (5, 0, 3):  # out of order: Markov states are memoized
        for attempt in range(3):
            np.testing.assert_array_equal(got.cohort(rnd, attempt),
                                          want.cohort(rnd, attempt))
    for plan in (want, got):
        plan.quarantine([1, 4], 2, 6)
        plan.quarantine([0], 4, 9)
    for rnd in range(10):
        for attempt in range(2):
            np.testing.assert_array_equal(
                got.member_mask(rnd, attempt),
                want.member_mask(rnd, attempt))


@pytest.mark.parametrize("policy,q,deadline", [
    ("wait_all", 1, None), ("quorum", 3, None), ("deadline", 1, 1.1)])
def test_fault_resolver_equals_reference(policy, q, deadline):
    n, c = 9, 4
    model = dict(p_drop=0.4, p_corrupt=0.3, straggler_frac=0.3)
    out = []
    for fmod, cmod, make in ((jfaults, jcohort, jrounds._make_fault_resolver),
                             (faults, cohort, rounds._make_fault_resolver)):
        plan = cmod.CohortPlan(1, n, c)
        resolve = make(fmod.FaultPlan(seed=2, n=n, **model), n=n,
                       policy=policy, q=q, max_retries=3, backoff0=0.5,
                       deadline=deadline, host_cohort=plan.cohort)
        out.append([resolve(g) for g in range(8)])
    for want, got in zip(*out):
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if policy == "quorum":
        assert any(r["retries"] for r in out[1])


def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 7, 9)).astype(np.float32),
            "b": rng.normal(size=(n, 50)).astype(np.float32),
            "c": rng.normal(size=(n, 3)).astype(np.float32)}


def _ws(tree):
    """The tree packed leaf by leaf (``jax.tree.leaves`` order) into an
    ``(n, d)`` workspace."""
    n = tree["a"].shape[0]
    return np.concatenate([tree[k].reshape(n, -1) for k in sorted(tree)],
                          axis=1)


@pytest.mark.parametrize("mode", ["nan", "inf", "blowup"])
def test_corrupt_rows_and_guard_match_reference(mode):
    n = 6
    tree = _tree(n)
    mask = np.array([0, 1, 0, 0, 1, 0], bool)
    member = np.array([1, 1, 0, 1, 1, 1], bool)
    want = jfaults.corrupt_rows({k: jnp.asarray(v) for k, v in tree.items()},
                                jnp.asarray(mask), mode)
    ws = torch.from_numpy(_ws(tree))
    faults.corrupt_rows(ws, mask, mode)
    assert ws.numpy().tobytes() == _ws(
        {k: np.asarray(v) for k, v in want.items()}).tobytes()
    for max_abs in (None, 1e3):
        bad_want = np.asarray(jfaults.nonfinite_clients(want, max_abs))
        bad = faults.nonfinite_clients(ws, member, max_abs)
        np.testing.assert_array_equal(bad, bad_want & member)


def _inputs(n, d, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    band = rng.integers(0, m, size=(d,)).astype(np.int32)
    return x, band


D, M, S = 3 * 4096 + 77, 4, 3
SLOT = np.array([2, -1, 0, -1, 3, -1], np.int32)  # row 1 dropped, 3, 5 idle


def test_masked_sum_counts_matches_pallas_interpret():
    x, band = _inputs(len(SLOT), D, M, 0)
    x[1] = np.nan  # a dropped row may hold anything
    num_w, cnt_w = juplink.masked_sum(
        jnp.asarray(x), jnp.asarray(SLOT), jnp.asarray(band), M, S,
        counts=True, interpret=True)
    num, cnt = uplink.masked_sum(torch.from_numpy(x), torch.from_numpy(SLOT),
                                 torch.from_numpy(band), M, S, counts=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_w))
    assert set(np.unique(cnt.numpy())) == {2.0, 3.0}
    np.testing.assert_allclose(num.numpy(), np.asarray(num_w), rtol=1e-6,
                               atol=1e-6)


# dropped and idle rows of NaN; "outside": bands outside [0, m), negative
# and >= m (the CUDA kernel's scalar path).  D % 4 != 0.
_EDGE_SLOTS = {1: [1], 5: [2, -1, 0, 3, -1],
               9: [2, -1, 0, 3, 1, -1, 3, -1, 0]}


@pytest.mark.parametrize("bands", ["in_range", "outside"])
@pytest.mark.parametrize("n", [1, 5, 9])
def test_masked_sum_counts_matches_pallas_interpret_at_edges(n, bands):
    slot = np.array(_EDGE_SLOTS[n], np.int32)
    x, band = _inputs(n, D, M, n)
    x[slot < 0] = np.nan
    if bands == "outside":
        band[::97] = -3
        band[5::89] = M + 3
        band[7::101] = -M - 1
    num_w, cnt_w = juplink.masked_sum(
        jnp.asarray(x), jnp.asarray(slot), jnp.asarray(band), M, S,
        counts=True, interpret=True)
    num, cnt = uplink.masked_sum(torch.from_numpy(x), torch.from_numpy(slot),
                                 torch.from_numpy(band), M, S, counts=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_w))
    assert np.isfinite(num.numpy()).all()
    np.testing.assert_allclose(num.numpy(), np.asarray(num_w), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("down", [None, np.array([1, 0, 1, 1, 0, 1], np.int32)])
def test_h_update_covered_matches_pallas_interpret_bitwise(down):
    # one arrived owner of three at s=3, m=4: a quarter of the
    # coordinates has no arrived owner
    slot = np.array([2, -1, -1, -1, -1, -1], np.int32)
    x, band = _inputs(len(slot), D, M, 1)
    x[3] = np.nan
    rng = np.random.default_rng(2)
    h = rng.normal(size=x.shape).astype(np.float32)
    x_bar = rng.normal(size=(D,)).astype(np.float32)
    _, cnt = juplink.masked_sum(jnp.asarray(x), jnp.asarray(slot),
                                jnp.asarray(band), M, S, counts=True,
                                interpret=True)
    covered = np.asarray(cnt) > 0
    assert 0.2 < 1 - covered.mean() < 0.3
    h_want, x_want = juplink.h_update(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(x_bar),
        jnp.asarray(slot), jnp.asarray(band), M, S, 0.37,
        down=None if down is None else jnp.asarray(down),
        covered=jnp.asarray(covered), interpret=True)
    xt, ht = torch.from_numpy(x.copy()), torch.from_numpy(h.copy())
    uplink.h_update(xt, ht, torch.from_numpy(x_bar), torch.from_numpy(slot),
                    torch.from_numpy(band), M, S, 0.37,
                    down=None if down is None else torch.from_numpy(down),
                    covered=torch.from_numpy(covered))
    assert ht.numpy().tobytes() == np.asarray(h_want).tobytes()
    assert xt.numpy().tobytes() == np.asarray(x_want).tobytes()
    unc = ~covered
    assert ht.numpy()[:, unc].tobytes() == h[:, unc].tobytes()
    assert xt.numpy()[:, unc].tobytes() == x[:, unc].tobytes()


def _np_slot(n, c, seed):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(n, c, replace=False))
    slot = np.full(n, -1, np.int32)
    slot[ids] = rng.permutation(c)
    return ids, slot


def _port_comm(tree, htree, slot, c, s, scale, **kw):
    ws, hs = torch.from_numpy(_ws(tree)), torch.from_numpy(_ws(htree))
    dims = [int(np.prod(tree[k].shape[1:])) for k in sorted(tree)]
    band = comm_ws.cyclic_band(dims, c, s, "cpu")
    comm_ws.cyclic_comm(ws, hs, torch.from_numpy(slot), band, c, s, scale,
                        **kw)
    return ws.numpy(), hs.numpy()


@pytest.mark.parametrize("correct", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_survivor_comm_matches_reference_pallas(correct, seed):
    n, c, s = 8, 5, 3
    tree, htree = _tree(n, seed), _tree(n, seed + 10)
    ids, slot = _np_slot(n, c, seed)
    arrived = np.random.default_rng(seed + 3).random(n) < 0.6
    arrived[ids[0]] = False
    for k in tree:  # a dropped member may hold anything
        tree[k][ids[0]] = np.nan
    down = np.zeros(n, bool)
    down[ids[1:]] = True
    want = jcomm.cyclic_comm(
        {k: jnp.asarray(v) for k, v in tree.items()},
        {k: jnp.asarray(v) for k, v in htree.items()},
        jnp.asarray(slot), c, s, 0.5, impl="pallas",
        down=jnp.asarray(down), arrived=jnp.asarray(arrived),
        correct=correct)
    xg, hg = _port_comm(tree, htree, slot, c, s, 0.5,
                        down=torch.from_numpy(down).to(torch.int32),
                        arrived=torch.from_numpy(arrived), correct=correct)
    for got, w in ((xg, want[0]), (hg, want[1])):
        w = _ws({k: np.asarray(v) for k, v in w.items()})
        np.testing.assert_array_equal(np.isnan(got), np.isnan(w))
        np.testing.assert_allclose(got, w, atol=2e-6)


@pytest.mark.parametrize("robust", [None, ("trimmed", 1), ("median", 0)])
def test_all_dropped_round_is_a_bitwise_no_op(robust):
    n, c, s = 6, 4, 3
    tree, htree = _tree(n), _tree(n, 5)
    _, slot = _np_slot(n, c, 0)
    xg, hg = _port_comm(tree, htree, slot, c, s, 0.5,
                        arrived=torch.zeros(n, dtype=torch.bool),
                        robust=robust)
    assert xg.tobytes() == _ws(tree).tobytes()
    assert hg.tobytes() == _ws(htree).tobytes()


N5, C4, S3 = 5, 4, 3


def _run(rounds_n, **kw):
    cfg = gemma2_2b.REDUCED
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C4, s=S3, p=0.5)
    state = tamuna_dp.init_state(cfg, tcfg, N5, seed=0, device="cpu")
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=16, per_client_batch=1, vocab=64, seed=0,
                   n_clients=N5), cfg, "cpu")
    return rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=rounds_n,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=2, **kw)


def test_zero_fault_plan_is_the_fault_free_run_bitwise():
    s0, rows0 = _run(2)
    s1, rows1 = _run(2, faults=faults.FaultPlan.zero(N5))
    assert s0.x.numpy().tobytes() == s1.x.numpy().tobytes()
    assert s0.h.numpy().tobytes() == s1.h.numpy().tobytes()
    assert [r["loss"] for r in rows0] == [r["loss"] for r in rows1]
    assert "arrivals" not in rows1[0]


def test_faulted_quorum_run_guards_quarantines_and_keeps_h_sum_zero():
    plan = cohort.CohortPlan(0, N5, C4)
    fplan = faults.FaultPlan(seed=0, n=N5, p_drop=0.25, p_corrupt=0.3,
                             corrupt_mode="nan")
    state, rows = _run(4, plan=plan, faults=fplan, policy="quorum",
                       quarantine_rounds=2)
    keys = ("arrivals", "corrupted", "retries", "backoff_s", "quorum_miss",
            "round_latency_s")
    assert all(k in r for r in rows for k in keys)
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert sum(r["corrupted"] for r in rows) > 0
    assert plan._quarantine  # the guard's verdict fed the plan
    assert bool(torch.isfinite(state.x).all())
    # the survivor mean keeps sum_i h_i = 0 up to f32 rounding (the
    # fault-free run's own ratio is 5e-6 here)
    ratio = float(state.h.sum(0).abs().max() / state.h.abs().max())
    assert ratio <= 1e-4, ratio
    assert all(r["arrivals"] <= C4 for r in rows)
    with pytest.raises(ValueError):
        _run(1, policy="quorum")
