"""The pipelined rounds of the port (``repro_torch.dist.rounds``:
``make_pipelined_round_fn``, ``run_rounds_pipelined`` and the pipe
checkpoints; ``CohortPlan.cohort_excluding``; ``comm_ws.uncovered_coords``
and ``make_comm_step(with_stats=True)``) against the reference.

* ``cohort_excluding`` is bitwise the reference's (both are numpy) over
  busy masks, attempts, availability models and quarantine windows, and
  ``uncovered_coords`` equals the reference's over random slots and
  arrivals on cyclic (tall leaves included) and blocked templates.
* ``run_rounds_pipelined(staleness=0)`` is ``run_rounds`` bitwise (x, h,
  every row's counters) fault-free, under a ``FaultPlan`` + ``CohortPlan``
  + quorum, on ``uplink="block_rs"`` and with ``elastic=False``.
* With the reference's cohorts injected (``rounds._uniform_cohort_host``
  and ``_free_uniform_cohort`` from ``jax.random.key(seed + 10)``, as
  ``benchmarks/pipeline_bench.py`` draws them) the port's driver at
  BENCH_pipeline.json's config gives every run's ``clock_s``, admitted,
  late-dropped and uncovered totals and local steps exactly.  The file was
  written under jax 0.4.37, whose threefry is not partitionable; under
  jax 0.9.0's default the reference draws other cohorts, so the test takes
  them with ``jax.threefry_partitionable(False)``.
* A staleness-1 run of the reduced gemma2-2b (n=6, c=3, s=2, 3 rounds)
  under ``wait_all`` and under ``quorum`` with a latency model, and an
  AdamW case (2 rounds) for the shared count, against the reference's
  per-step pieces (gather, local step, scatter, comm step ``impl="ws"``)
  composed in the pipelined order with the same schedule, permutations
  and batches: x, h and the losses within 1e-5
  (``tests/test_torch_round.py``'s tolerance).  Each round takes one local
  step (``max_L=1``): the two frameworks' gradient roundings add up over
  the rounds, and through the h update (``eta / gamma = 6`` here) a run
  with a round of two steps put the embedding's h 2.2e-5 apart with x
  7.2e-6 apart (measured on the CPU).  AdamW holds the columns where its
  first step's ``g - h`` lies within 1e-5 of 0 to ``2 gamma``, as
  ``tests/test_torch_round_options.py`` does.
* An in-flight round's rows (x, h and AdamW's moments) are bitwise
  untouched by another round's commit, on every comm path: the kernel
  path's mean, survivor and robust rebuilds behind corruption, a
  Byzantine row and the adaptive guard, ``ws``, ``dense``, ``block_rs``,
  the int8 wire and tall-and-thin leaves.
* A resume from a pipe checkpoint with a round in flight is bitwise the
  uninterrupted run, clock and local steps included; the reference's
  ``pipeline_latest_step`` finds the port's ``pipe_step_<k>`` while both
  ``latest_step``s ignore it, and the port restores a pipe checkpoint the
  reference wrote.
* The driver refuses what the reference refuses, with its texts.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.dist import cohort as jcohort
from repro.dist import comm_ws as jcomm_ws
from repro.dist import model_api as japi
from repro.dist import rounds as jrounds
from repro.dist import tamuna_dp as jtd
from repro.optim import optimizers as jopt
from repro_torch import checkpoint
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import cohort, comm_ws, faults, rounds, tamuna_dp
from repro_torch.launch import pipeline_bench
from repro_torch.optim import optimizers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
            d_ff=32, vocab=64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(tiny=True):
    jcfg = jregistry.get_reduced_config("gemma2-2b")
    cfg = registry.get_reduced_config("gemma2-2b")
    if tiny:
        jcfg = dataclasses.replace(jcfg, **TINY)
        cfg = dataclasses.replace(cfg, **TINY)
    return jcfg, cfg


def _pipe(cfg, n, seq=8):
    return SyntheticTokenPipeline(
        DataConfig(seq_len=seq, per_client_batch=1, vocab=64, seed=0,
                   n_clients=n), cfg, "cpu")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().copy()


# --------------------------------------------------------------------------
# cohort_excluding and uncovered_coords
# --------------------------------------------------------------------------


@pytest.mark.parametrize("avail", [None, "bernoulli", "markov"])
@pytest.mark.parametrize("quarantine", [False, True])
def test_cohort_excluding_matches_reference(avail, quarantine):
    n, c = 12, 3

    def make(mod):
        a = None
        if avail == "bernoulli":
            a = mod.BernoulliAvailability(np.linspace(0.3, 0.95, n), seed=4)
        elif avail == "markov":
            a = mod.MarkovAvailability(0.2, 0.5, n=n, seed=4)
        plan = mod.CohortPlan(9, n, c, availability=a)
        if quarantine:
            plan.quarantine([1, 5], 2, 6)
        return plan

    mine, ref = make(cohort), make(jcohort)
    rng = np.random.default_rng(0)
    for rnd in range(10):
        for attempt in (0, 1, 2):
            for frac in (0.0, 0.3, 0.6, 0.85):
                busy = rng.random(n) < frac
                if int((~busy).sum()) < c:
                    with pytest.raises(ValueError) as want:
                        ref.cohort_excluding(rnd, busy, attempt)
                    with pytest.raises(ValueError) as got:
                        mine.cohort_excluding(rnd, busy, attempt)
                    assert str(got.value) == str(want.value)
                    continue
                got = mine.cohort_excluding(rnd, busy, attempt)
                want = ref.cohort_excluding(rnd, busy, attempt)
                assert got.dtype == want.dtype == np.int32
                assert np.array_equal(got, want), (rnd, attempt, busy)
                assert not busy[got].any()
    free = np.zeros(n, bool)
    assert np.array_equal(mine.cohort_excluding(3, free, 1),
                          mine.cohort(3, 1))
    with pytest.raises(ValueError, match="busy mask shape"):
        mine.cohort_excluding(0, np.zeros(n - 1, bool))


@pytest.mark.parametrize("template,m,s", [
    ("cyclic", 6, 2), ("cyclic", 7, 3), ("cyclic", 40, 2),
    ("blocked", 6, 2), ("blocked", 5, 3), ("blocked", 40, 2)])
def test_uncovered_coords_matches_reference(template, m, s):
    # at m = 40 the leaves of 16, 1, 3 and 5 are tall (D s < m)
    dims = (16, 1, 3, 97, 128, 5, 1000)
    n = m + 3
    rng = np.random.default_rng(10 * m + s)
    for D in dims:
        if template == "blocked":
            assert np.array_equal(comm_ws._block_band_counts_np(D, m),
                                  jcomm_ws._block_band_counts_np(D, m))
        elif D * s >= m:
            assert np.array_equal(comm_ws._cyclic_band_counts_np(D, m, s),
                                  jcomm_ws._cyclic_band_counts_np(D, m, s))
    seen = set()
    for _ in range(24):
        slot = np.full(n, -1, np.int32)
        slot[rng.choice(n, m, replace=False)] = rng.permutation(m)
        slot[rng.random(n) < rng.choice([0.0, 0.3, 0.6, 0.9])] = -1
        want = int(jcomm_ws.uncovered_coords(
            template, dims, m, s, jnp.asarray(slot)))
        got = comm_ws.uncovered_coords(template, dims, m, s, slot)
        assert got == want, (slot, got, want)
        seen.add(got)
    assert len(seen) > 2  # the patterns reach several counts


@pytest.mark.parametrize("uplink", ["masked_psum", "block_rs"])
def test_comm_step_with_stats(uplink):
    """``with_stats`` returns the same state bitwise and the reference's
    uncovered count of the slots the step aggregated with."""
    _, cfg = _configs()
    n, c, s = 6, 4, 2
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=s, p=0.5,
                                      uplink=uplink)
    rng = np.random.default_rng(1)
    cohort_ = np.array([0, 2, 3, 5])
    down = np.array([1, 1, 0, 0, 1, 0], bool)
    tmpl = ({"off": 3} if uplink == "block_rs"
            else {"perm": [2, 0, 3, 1]})
    for arrived in (None, np.array([1, 1, 0, 0, 1, 1], bool),
                    np.array([1, 1, 1, 0, 1, 0], bool)):
        states = []
        for stats in (False, True):
            st = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
            st.x.add_(torch.from_numpy(rng.normal(
                size=st.x.shape).astype(np.float32)) * 0.01)
            states.append(st)
        states[1].x.copy_(states[0].x)
        a = tamuna_dp.make_comm_step(cfg, tcfg, n, device="cpu")(
            states[0], cohort_, down=down, arrived=arrived, **tmpl)
        b, info = tamuna_dp.make_comm_step(cfg, tcfg, n, device="cpu",
                                           with_stats=True)(
            states[1], cohort_, down=down, arrived=arrived, **tmpl)
        assert torch.equal(a.x, b.x) and torch.equal(a.h, b.h)
        assert (a.round, a.up_floats) == (b.round, b.up_floats)
        slot_of = np.full(n, -1)
        slot_of[cohort_] = np.arange(c)
        if uplink == "block_rs":
            sslot = np.where(slot_of >= 0, (-(slot_of + 3)) % c, -1)
            template = "blocked"
        else:
            sslot = np.where(slot_of >= 0,
                             np.asarray(tmpl["perm"])[slot_of], -1)
            template = "cyclic"
        if arrived is not None:
            sslot = np.where(arrived, sslot, -1)
        want = jcomm_ws.uncovered_coords(template, tuple(b.spec.dims), c, s,
                                         jnp.asarray(sslot, jnp.int32))
        assert info["uncovered"] == int(want)


# --------------------------------------------------------------------------
# staleness 0 is run_rounds
# --------------------------------------------------------------------------

SYNC_CASES = {
    "fault_free": ({}, {}),
    "faults_plan_quorum": ({}, {"plan": True, "faults": True,
                                "policy": "quorum"}),
    "block_rs": ({"uplink": "block_rs"}, {}),
    "all_rows": ({}, {"elastic": False}),
}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_staleness0_is_run_rounds(case):
    _, cfg = _configs()
    n = 8
    tkw, rkw = SYNC_CASES[case]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.5, **tkw)

    def kw():
        out = dict(rkw)
        if out.pop("plan", False):
            out["plan"] = cohort.CohortPlan(5, n, 3)
        if out.pop("faults", False):
            out["faults"] = faults.FaultPlan(seed=2, n=n, p_drop=0.3,
                                             p_corrupt=0.2)
        return out

    a = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    a, want = rounds.run_rounds(
        a, cfg=cfg, tcfg=tcfg, pipe=_pipe(cfg, n), rounds=6,
        rng=np.random.default_rng(3),
        generator=torch.Generator().manual_seed(1), max_L=4, **kw())
    pkw = kw()
    engine = rounds.make_pipelined_round_fn(
        cfg, tcfg, n, pipe=_pipe(cfg, n), max_L=4,
        elastic=pkw.pop("elastic", None), device="cpu")
    b = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    b, got = rounds.run_rounds_pipelined(
        b, round_fn=engine, rounds=6, rng=np.random.default_rng(3),
        generator=torch.Generator().manual_seed(1), p=tcfg.p, staleness=0,
        flush_every=4, **pkw)
    assert torch.equal(a.x, b.x) and torch.equal(a.h, b.h)
    assert a.round == b.round == 6
    keys = ["round", "L", "loss", "local_steps", "up_floats", "down_floats",
            "up_bytes", "down_bytes"]
    if "faults" in rkw:
        keys += ["arrivals", "corrupted", "retries", "backoff_s",
                 "quorum_miss"]
        assert sum(r["retries"] for r in want) > 0  # the resolver retried
        assert all("uncovered" in r for r in got)
    assert [[r[k] for k in keys] for r in want] == \
        [[r[k] for k in keys] for r in got]
    assert all(r["staleness"] == 0 for r in got)


# --------------------------------------------------------------------------
# the clock of BENCH_pipeline.json
# --------------------------------------------------------------------------

with open(os.path.join(REPO, "BENCH_pipeline.json")) as _f:
    _BENCH = json.load(_f)
BENCH_RUNS = _BENCH["rows"] + _BENCH["sync_seeds"][1:]


class _ReferenceCohorts:
    """The cohorts ``benchmarks/pipeline_bench.py``'s runs drew: the
    reference driver's uniform cohort, and its busy-aware draw when rounds
    are in flight, from the comm key of ``jax.random.key(seed + 10)``."""

    def __init__(self, seed, n, c):
        _, kc = jax.random.split(jax.random.key(seed + 10))
        self.ck0 = np.asarray(jax.random.key_data(kc))
        self.n, self.c = n, c

    def cohort(self, g, attempt=0):
        return jrounds._uniform_cohort_host(self.ck0, g, self.n, self.c,
                                            attempt)

    def cohort_excluding(self, g, busy, attempt=0):
        busy = np.asarray(busy, bool)
        if not busy.any():
            return self.cohort(g, attempt)
        return jrounds._free_uniform_cohort(self.ck0, g, self.n, self.c,
                                            busy)


@pytest.mark.parametrize("want", BENCH_RUNS, ids=[
    f"tau{r['tau']}-{r['policy']}-seed{r['seed']}" for r in BENCH_RUNS])
def test_clock_reproduces_bench_pipeline(want):
    with jax.threefry_partitionable(False):
        got = pipeline_bench.run_one(
            want["tau"], want["policy"], want["quorum"], want["seed"],
            device="cpu", plan=_ReferenceCohorts(
                want["seed"], pipeline_bench.N, pipeline_bench.C))
    for k in ("clock_s", "admitted_total", "late_dropped_total",
              "uncovered_total", "local_steps"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["finite"]


# --------------------------------------------------------------------------
# staleness 1 against the reference's per-step composition
# --------------------------------------------------------------------------

N1, C1, S1, SEQ1 = 6, 3, 2, 16


class _ScriptedPipe:
    """Batches in call order from a fixed numpy stream (both sides take
    the same tokens), with the generator a pipe checkpoint would save."""

    def __init__(self, toks):
        self.toks, self.used = toks, 0
        self.generator = torch.Generator()

    def sample_batch(self, clients):
        tk = torch.from_numpy(self.toks[self.used]).long()
        self.used += 1
        return {"tokens": tk[..., :-1], "labels": tk[..., 1:]}


def _start(jcfg, n, seed):
    params = japi.init(jax.random.key(0), jcfg)
    names, leaves, treedef = jckpt._flatten_with_names(params)
    rng = np.random.default_rng(seed)
    x0 = [np.asarray(a)[None] + 0.01 * rng.normal(
        size=(n,) + a.shape).astype(np.float32) for a in leaves]
    h0 = [0.01 * rng.normal(size=(n,) + a.shape).astype(np.float32)
          for a in leaves]
    h0 = [(a - a.mean(axis=0, keepdims=True)).astype(np.float32)
          for a in h0]
    return names, treedef, x0, h0


def _port_state(cfg, tcfg, names, x0, h0):
    spec = tamuna_dp.state_spec(cfg, tcfg)
    n = x0[0].shape[0]
    x, h = torch.empty(n, spec.d_total), torch.empty(n, spec.d_total)
    comm_ws.pack({k: torch.from_numpy(a) for k, a in zip(names, x0)}, spec, x)
    comm_ws.pack({k: torch.from_numpy(a) for k, a in zip(names, h0)}, spec, h)
    opt = ()
    if tcfg.local_opt == "adamw":
        opt = optimizers.AdamState(torch.zeros_like(x), torch.zeros_like(x),
                                   0)
    return tamuna_dp.DistTamunaState(x=x, h=h, spec=spec, opt=opt)


TAU1_CASES = {
    "wait_all": dict(policy="wait_all", rounds=3, max_L=1, opt="sgd"),
    "quorum": dict(policy="quorum", quorum=1, rounds=3, max_L=1, opt="sgd"),
    "adamw": dict(policy="wait_all", rounds=2, max_L=1, opt="adamw"),
}


@pytest.fixture(scope="module")
def reduced1():
    jcfg, cfg = _configs(tiny=False)
    names, treedef, x0, h0 = _start(jcfg, N1, 7)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab, size=(12, C1, 1, SEQ1 + 1)
                        ).astype(np.int32)
    keys = [jax.random.key_data(jax.random.key(100 + g)) for g in range(4)]
    perms = [np.asarray(jax.random.permutation(
        jax.random.split(jax.random.wrap_key_data(k))[1], C1)) for k in keys]
    return dict(jcfg=jcfg, cfg=cfg, names=names, treedef=treedef, x0=x0,
                h0=h0, toks=toks, keys=keys, perms=perms, jit={})


def _port_tau1(ref, case):
    c = TAU1_CASES[case]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C1, s=S1, p=0.5,
                                      local_opt=c["opt"])
    state = _port_state(ref["cfg"], tcfg, ref["names"], ref["x0"], ref["h0"])
    engine = rounds.make_pipelined_round_fn(
        ref["cfg"], tcfg, N1, pipe=_ScriptedPipe(ref["toks"]),
        max_L=c["max_L"], device="cpu")
    perms = iter(ref["perms"])
    engine.template = lambda gen: {"perm": next(perms).tolist(), "off": None}
    log = {"stage": [], "commit": []}
    stage, commit = engine.stage, engine.commit

    def rec_stage(state, L, cohort=None):
        buf = stage(state, L, cohort)
        log["stage"].append((np.asarray(cohort), buf["steps"]))
        return buf

    def rec_commit(state, buf, cohort, down=None, **kw):
        log["commit"].append(dict(down=np.asarray(down, bool),
                                  arrived=kw.get("arrived"),
                                  correct=kw.get("correct", True)))
        return commit(state, buf, cohort, down, **kw)

    engine.stage, engine.commit = rec_stage, rec_commit
    lat = faults.EmpiricalDelays([0.05, 0.1, 3.0], n=N1, seed=5)
    state, rows = rounds.run_rounds_pipelined(
        state, round_fn=engine, rounds=c["rounds"],
        rng=np.random.default_rng(3),
        generator=torch.Generator().manual_seed(1), p=0.5, staleness=1,
        flush_every=2, latency=lat, policy=c["policy"],
        quorum=c.get("quorum"))
    return state, rows, log


def _reference_tau1(ref, case, log):
    c = TAU1_CASES[case]
    jt = jtd.DistTamunaConfig(gamma=0.05, c=C1, s=S1, p=0.5,
                              local_opt=c["opt"])
    if c["opt"] not in ref["jit"]:
        ref["jit"][c["opt"]] = (
            jax.jit(jtd.make_local_step(ref["jcfg"], jt)),
            jax.jit(jtd.make_comm_step(ref["jcfg"], jt, _mesh(), impl="ws",
                                       n=N1), static_argnames=("correct",)))
    local, comm = ref["jit"][c["opt"]]
    unflat = lambda ls: jax.tree.unflatten(ref["treedef"],
                                           [jnp.asarray(a) for a in ls])
    x = unflat(ref["x0"])
    zero = jnp.zeros((), jnp.float32)
    state = jtd.DistTamunaState(
        x=x, h=unflat(ref["h0"]),
        opt=jopt.adamw(0.05).init(x) if c["opt"] == "adamw" else (),
        round=jnp.zeros((), jnp.int32), up_floats=zero, down_floats=zero,
        up_bytes=zero, down_bytes=zero)
    pending, losses, near0, used = [], [], None, 0
    for u in range(c["rounds"] + 1):
        if u < c["rounds"]:
            co, steps = log["stage"][u]
            cj = jnp.asarray(co, jnp.int32)
            compact, tot = jtd.gather_cohort(state, cj), 0.0
            for _ in range(steps):
                tk = jnp.asarray(ref["toks"][used])
                used += 1
                compact, m = local(compact, tokens=tk[..., :-1],
                                   labels=tk[..., 1:])
                tot += float(m["loss"])
            if c["opt"] == "adamw":
                # g - h of the round's only step, from the first moment
                eff = [np.abs(np.asarray(a) / 0.1) <= 1e-5
                       for a in jax.tree.leaves(compact.opt.mu)]
                near = [e.any(axis=0) for e in eff]
                near0 = near if near0 is None else [
                    a | b for a, b in zip(near0, near)]
            pending.append((cj, compact, tot / steps))
        rc = u - 1
        if 0 <= rc < c["rounds"]:
            cj, compact, loss = pending.pop(0)
            cm = log["commit"][rc]
            state = jtd.scatter_cohort(state, compact, cj)
            kw = ({} if cm["arrived"] is None else
                  dict(arrived=jnp.asarray(cm["arrived"]),
                       correct=cm["correct"]))
            state = comm(state, ref["keys"][rc], cohort=cj,
                         down=jnp.asarray(cm["down"]), **kw)
            losses.append(loss)
    return state, losses, near0


@pytest.mark.parametrize("case", list(TAU1_CASES))
def test_staleness1_matches_reference_composition(reduced1, case):
    ref = reduced1
    got, rows, log = _port_tau1(ref, case)
    cohorts = [co for co, _ in log["stage"]]
    # in-flight cohorts are disjoint, and each commit prefetches the
    # DownCom to the cohort of round g + 2
    for g in range(len(cohorts) - 1):
        assert not set(cohorts[g]) & set(cohorts[g + 1])
    for g in range(len(cohorts) - 2):
        want_down = np.zeros(N1, bool)
        want_down[cohorts[g + 2]] = True
        assert np.array_equal(log["commit"][g]["down"], want_down)
    want, losses, near0 = _reference_tau1(ref, case, log)
    for r, w in zip(rows, losses):
        assert abs(r["loss"] - w) <= 1e-5 * abs(w), (r["loss"], w)
    if case == "quorum":
        assert sum(r["late_dropped"] for r in rows) > 0
        assert sum(r["uncovered"] for r in rows) > 0
    spec = got.spec
    pairs = [(got.x, want.x), (got.h, want.h)]
    scale = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C1, s=S1,
                                       p=0.5).eta_(N1) / 0.05
    if case == "adamw":
        pairs += [(got.opt.mu, want.opt.mu), (got.opt.nu, want.opt.nu)]
        # the commit of round 0 runs after round 1's stage: last-wins
        assert got.opt.count == int(want.opt.count) == 1
    for ws, tree in pairs:
        gv = comm_ws.unpack(ws, spec)
        for i, (k, w) in enumerate(zip(ref["names"], jax.tree.leaves(tree))):
            diff = np.abs(gv[k].numpy() - np.asarray(w))
            if near0 is not None and (ws is got.x or ws is got.h):
                cols = np.broadcast_to(near0[i], diff.shape)
                bound = 2 * 0.05 * (1.0 if ws is got.x else 2 * scale) + 1e-5
                assert diff[cols].max(initial=0.0) <= bound, (case, k)
                diff = diff[~cols]
            assert diff.max(initial=0.0) <= 1e-5, (case, k, diff.max())
    assert got.round == int(want.round)
    for k in ("up_floats", "down_floats", "up_bytes", "down_bytes"):
        w = float(getattr(want, k))
        assert abs(float(getattr(got, k)) - w) <= 1e-5 * w, k


# --------------------------------------------------------------------------
# in-flight rows, resume, checkpoint names, refusals
# --------------------------------------------------------------------------

INFLIGHT = {
    "mean": {},
    "survivor": {"arrived": True},
    "robust": {"tcfg": dict(s=3, robust_agg="trimmed", trim_k=1),
               "arrived": True, "faults": True, "n": 12, "c": 5},
    "ws": {"tcfg": dict(comm_impl="ws"), "arrived": True},
    "dense": {"tcfg": dict(comm_impl="dense"), "arrived": True},
    "block_rs": {"tcfg": dict(uplink="block_rs"), "arrived": True},
    "int8_wire": {"tcfg": dict(wire_precision="int8", wire_down=True),
                  "arrived": True},
    "adamw": {"tcfg": dict(local_opt="adamw")},
    "tall": {"n": 70, "c": 34},
}


@pytest.mark.parametrize("case", list(INFLIGHT))
def test_inflight_rows_untouched_by_another_commit(case):
    spec_ = INFLIGHT[case]
    _, cfg = _configs()
    n, c = spec_.get("n", 8), spec_.get("c", 3)
    tcfg = tamuna_dp.DistTamunaConfig(**{
        **dict(gamma=0.05, c=c, s=2, p=0.5), **spec_.get("tcfg", {})})
    if case == "tall":
        assert comm_ws.tall_leaves(tamuna_dp.state_spec(cfg, tcfg).dims,
                                   c, 2)
    engine = rounds.make_pipelined_round_fn(cfg, tcfg, n, pipe=_pipe(cfg, n),
                                            max_L=2, device="cpu")
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    state.x.add_(0.01 * torch.randn(state.x.shape,
                                    generator=torch.Generator().manual_seed(2)))
    rows = np.arange(n)
    A, B = rows[:c], rows[c:2 * c]
    down = np.zeros(n, bool)
    down[[0, n - 1]] = True  # a committed row and a free one
    tmpl = engine.template(torch.Generator().manual_seed(4))
    bufA = engine.stage(state, 2, A)
    bufB = engine.stage(state, 2, B)
    wss = [state.x, state.h]
    if tcfg.local_opt == "adamw":
        wss += [state.opt.mu, state.opt.nu]
    before = [_bits(ws[torch.as_tensor(B)]) for ws in wss]
    hA = state.h[torch.as_tensor(A)].clone()
    kw = {}
    if spec_.get("arrived"):
        arrived = np.ones(n, bool)
        arrived[A[-1]] = False
        kw.update(arrived=arrived, correct=True)
    if spec_.get("faults"):
        corrupt = np.zeros(n, bool)
        corrupt[A[0]] = True
        byz = np.zeros(n, bool)
        byz[A[1]] = True
        kw.update(corrupt=corrupt, byz=byz, guard=True,
                  guard_mode="adaptive",
                  model=faults.FaultModel(p_corrupt=0.5, corrupt_mode="nan",
                                          adversary="sign_flip", f_byz=0.2))
    state, info = engine.commit(state, bufA, A, down, **tmpl,
                                wire_seed=7 if engine.on_wire else None,
                                **kw)
    after = [_bits(ws[torch.as_tensor(B)]) for ws in wss]
    for b, a in zip(before, after):
        assert np.array_equal(a, b), case
    assert not torch.equal(state.h[torch.as_tensor(A)], hA)
    if spec_.get("faults"):
        assert info["bad"][A[0]]  # the NaN row was caught and zeroed
    # the in-flight round then commits as usual
    state, _ = engine.commit(state, bufB, B, np.zeros(n, bool), **tmpl,
                             wire_seed=8 if engine.on_wire else None)
    assert bool(torch.isfinite(state.h).all())


def _resume_run(tmp, rounds_, resume):
    _, cfg = _configs()
    n = 8
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.5,
                                      local_opt="adamw")
    engine = rounds.make_pipelined_round_fn(cfg, tcfg, n, pipe=_pipe(cfg, n),
                                            max_L=3, device="cpu")
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    return rounds.run_rounds_pipelined(
        state, round_fn=engine, rounds=rounds_,
        rng=np.random.default_rng(3),
        generator=torch.Generator().manual_seed(1), p=0.5, staleness=1,
        flush_every=3, checkpoint_dir=tmp, checkpoint_every=3,
        latency=faults.EmpiricalDelays([0.05, 0.1, 3.0], n=n, seed=5),
        policy="quorum", quorum=2, resume=resume)


def test_mid_flight_resume_is_bitwise(tmp_path):
    whole_dir, part_dir = str(tmp_path / "whole"), str(tmp_path / "part")
    whole, rows = _resume_run(whole_dir, 6, False)
    assert rounds.pipeline_latest_step(whole_dir) == 3
    # the resumed run starts from pipe_step_3 with round 3 in flight
    os.makedirs(part_dir)
    os.rename(os.path.join(whole_dir, "pipe_step_3"),
              os.path.join(part_dir, "pipe_step_3"))
    resumed, tail = _resume_run(part_dir, 6, True)
    for a, b in ((whole.x, resumed.x), (whole.h, resumed.h),
                 (whole.opt.mu, resumed.opt.mu),
                 (whole.opt.nu, resumed.opt.nu)):
        assert torch.equal(a, b)
    assert whole.opt.count == resumed.opt.count
    for k in ("round", "up_floats", "down_floats", "up_bytes", "down_bytes"):
        assert getattr(whole, k) == getattr(resumed, k), k
    strip = lambda rs: [{k: v for k, v in r.items() if k != "seconds"}
                        for r in rs]
    assert strip(rows[3:]) == strip(tail)
    assert tail[-1]["commit_s"] == rows[-1]["commit_s"]
    assert tail[-1]["local_steps"] == rows[-1]["local_steps"]


def test_pipe_checkpoint_names_and_reference_interop(tmp_path):
    root = str(tmp_path / "ck")
    _resume_run(root, 4, False)
    path = os.path.join(root, "pipe_step_3")
    names = checkpoint.load_named(path)
    for nm in ("carry/.state/.x/embed", "carry/.state/.opt/.count",
               "carry/.data_generator", "carry/.comm_generator",
               "pending/0/compact/.x/embed", "pending/0/compact/.opt/.mu/embed",
               "pending/0/cohort", "pending/0/template", "pending/0/r",
               "clock/last_commit", "clock/last_dispatch",
               "clock/total_steps"):
        assert nm in names, nm
    assert jrounds.pipeline_latest_step(root) == 3
    assert checkpoint.latest_step(root) is None
    assert jckpt.latest_step(root) is None

    # a pipe checkpoint the reference writes, restored by the port
    jcfg, cfg = _configs()
    n, c = 8, 3
    jt = jtd.DistTamunaConfig(gamma=0.05, c=c, s=2, p=0.5)
    jstate = jtd.init_state(jax.random.key(0), jcfg, _mesh(), jt, n=n)
    carry = jrounds.init_carry(jstate, jax.random.key(1), 4)
    co = np.array([1, 4, 6], np.int32)
    compact = jtd.gather_cohort(jstate, jnp.asarray(co))
    compact = compact._replace(x=jax.tree.map(lambda a: a + 1.0, compact.x))
    rpath = str(tmp_path / "ref" / "pipe_step_4")
    jrounds.pipeline_checkpoint_save(
        rpath, carry,
        [{"buf": {"compact": compact, "loss": jnp.float32(3.5), "steps": 2},
          "r": 4, "cohort": co, "dispatch": 1.25}],
        {"last_dispatch": np.float32(1.25), "last_commit": np.float32(2.5),
         "total_steps": np.int32(9)}, 4)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=2, p=0.5)
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=3, device="cpu")
    engine = rounds.make_pipelined_round_fn(cfg, tcfg, n, pipe=_pipe(cfg, n),
                                            device="cpu")
    blob = rounds.pipeline_checkpoint_restore(
        rpath, state=state, engine=engine,
        generator=torch.Generator().manual_seed(0))
    xs = comm_ws.unpack(state.x, state.spec)
    for k, w in zip(*_named_leaves(jstate.x)):
        want = np.asarray(w).copy()
        want[co] += 1.0
        assert np.array_equal(xs[k].numpy(), want), k
    (e,) = blob["pending"]
    assert (e["r"], e["dispatch"], e["buf"]["steps"]) == (4, 1.25, 2)
    assert np.array_equal(e["cohort"], co)
    assert float(e["buf"]["loss"]) == 3.5
    assert e["buf"]["compact"].rows == co.tolist()
    assert blob["clock"] == {"last_dispatch": 1.25, "last_commit": 2.5,
                             "total_steps": 9}


def _named_leaves(tree):
    names, leaves, _ = jckpt._flatten_with_names(tree)
    return names, leaves


def _stub_engine(n=8, c=3, elastic=True):
    return types.SimpleNamespace(stage=None, commit=None, n=n, c=c,
                                 max_L=4, elastic=elastic, coverage=True)


REFUSALS = {
    "not_an_engine": (dict(round_fn=object()), {}),
    "negative_staleness": (dict(staleness=-1), {}),
    "unknown_policy": (dict(policy="fastest"), {}),
    "deadline_without_seconds": (dict(policy="deadline"), {}),
    "all_rows_pipelined": (dict(round_fn=_stub_engine(elastic=False)), {}),
    "too_deep": (dict(staleness=2), {}),
    "bad_guard_mode": (dict(guard_mode="strict"), {}),
    "fault_plan_size": (dict(faults=True), {"faults_n": 5}),
    "policy_without_faults": (dict(policy="quorum", staleness=0), {}),
    "latency_size": (dict(latency=True), {"latency_n": 5}),
    "resume_without_dir": (dict(resume=True), {}),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_driver_refusals_match_reference(case):
    kw, extra = REFUSALS[case]

    def args(fmod):
        out = dict(round_fn=_stub_engine(), rounds=2, p=0.5, staleness=1,
                   rng=np.random.default_rng(0))
        out.update(kw)
        if out.get("faults") is True:
            out["faults"] = fmod.FaultPlan(seed=0, n=extra["faults_n"])
        if out.get("latency") is True:
            out["latency"] = fmod.EmpiricalDelays([1.0],
                                                  n=extra["latency_n"])
        return out

    from repro.dist import faults as jfaults

    with pytest.raises(ValueError) as want:
        jrounds.run_rounds_pipelined(types.SimpleNamespace(round=0),
                                     data=None, key=jax.random.key(0),
                                     **args(jfaults))
    with pytest.raises(ValueError) as got:
        rounds.run_rounds_pipelined(
            types.SimpleNamespace(round=0, x=torch.zeros(1)),
            generator=torch.Generator(), **args(faults))
    assert str(got.value) == str(want.value)
