"""The options of the synchronous round against the reference
(``repro.dist.tamuna_dp``): microbatched gradients, the AdamW local step,
one reduced round each with AdamW, with ``uplink="block_rs"``, with
``elastic=False`` (the all-rows round) and with ``comm_impl`` ``"ws"`` and
``"dense"``, and every config validation error.

* ``_client_grads`` at M = 1, 2, 4 microbatches on a 1-layer model of
  width 16 against the reference's (vmapped, scanned over the
  microbatches): losses within 1e-6 relative and gradients within 5e-6 of
  each leaf's largest value (the two frameworks sum the products in other
  orders, 1.4e-6 at M = 1 already; the microbatch sum and the ``* (1/M)``
  are the same operations);
* the AdamW local step on that model, 3 members and 2 steps, against the
  reference's ``make_local_step``: x within 1e-5, mu and nu within 1e-6, and the shared count at 2 in both (once per local step, not
  per member);
* the reduced gemma2-2b rounds (n=4, c=3, s=2, L=2, the schedule, the
  shift and the batches injected) against the reference's per-step
  composition on a 1x1 mesh, x and h within 1e-5 (the tolerance of
  ``tests/test_torch_round.py``), the counters within 1e-5 relative.
  The AdamW round takes one local step: its moments are held within 1e-5,
  and so are x and h at every coordinate where the reference's ``g - h``
  lies above 1e-5 in every cohort row.  AdamW's first step is ``(g - h) /
  (|g - h| + eps)``, close to ``sign(g - h)``: where ``g - h`` lies within
  the two frameworks' gradient rounding of 0 the two step apart by up to
  ``2 gamma`` (13 coordinates of this round), and up to 1e-5 from it the
  step's slope ``eps / |g - h|^2`` turns that rounding into more than
  1e-5; those columns (0.23% of them) are held to ``2 gamma``, the
  bound of an AdamW step (x_bar and the owners' h carry it on).  A second local step
  would run from models that differ there, and its gradients differ
  everywhere beyond 1e-5, so the round is held after one;
* ``run_rounds(elastic=False)`` trains every row and sends the DownCom to
  every row, and equals its own composition bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.dist import model_api as japi
from repro.dist import tamuna_dp as jtd
from repro.optim import optimizers as jopt
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import comm_ws, model_api, rounds, tamuna_dp

N, C, S, L = 4, 3, 2, 2
SEQ, BATCH = 32, 2
COHORT = [0, 2, 3]
DOWN = np.array([True, True, False, True])
TINY = dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
            d_ff=32, vocab=64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(tiny=False):
    jcfg = jregistry.get_reduced_config("gemma2-2b")
    cfg = registry.get_reduced_config("gemma2-2b")
    if tiny:
        jcfg = dataclasses.replace(jcfg, **TINY)
        cfg = dataclasses.replace(cfg, **TINY)
    return jcfg, cfg


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
    return names, treedef, x0, h0, rng


def _unflat(treedef, leaves):
    return jax.tree.unflatten(treedef, [jnp.asarray(a) for a in leaves])


# --------------------------------------------------------------------------
# microbatches and the AdamW step on a tiny model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 2, 4])
def test_client_grads_microbatches_match_reference(M):
    jcfg, cfg = _configs(tiny=True)
    names, treedef, x0, _, rng = _start(jcfg, 2, 1)
    toks = rng.integers(0, jcfg.vocab, size=(2, 4, 9)).astype(np.int32)
    jl, jg = jax.jit(jtd._client_grads, static_argnums=(0, 3))(
        jcfg, _unflat(treedef, x0),
        {"tokens": jnp.asarray(toks[..., :-1]),
         "labels": jnp.asarray(toks[..., 1:])}, M)
    jg = dict(zip(names, jax.tree.leaves(jg)))
    for i in range(2):
        params = {k: torch.from_numpy(a[i].copy()).requires_grad_(True)
                  for k, a in zip(names, x0)}
        tk = torch.from_numpy(toks[i]).long()
        loss, grads = tamuna_dp._client_grads(
            cfg, params, {"tokens": tk[..., :-1], "labels": tk[..., 1:]}, M)
        assert abs(float(loss) - float(jl[i])) <= 1e-6 * abs(float(jl[i]))
        for k, g in zip(names, grads):
            w = np.asarray(jg[k][i])
            top = max(np.abs(w).max(), 1e-30)
            assert np.abs(g.numpy() - w).max() <= 5e-6 * top, (M, k)
    with pytest.raises(ValueError, match="microbatches"):
        tamuna_dp._client_grads(
            cfg, params, {"tokens": tk[:3, :-1], "labels": tk[:3, 1:]}, 2)


def test_adamw_local_step_and_its_count_match_reference():
    jcfg, cfg = _configs(tiny=True)
    n, c = 4, 3
    kw = dict(gamma=0.05, c=c, s=2, p=0.34, local_opt="adamw")
    names, treedef, x0, h0, rng = _start(jcfg, n, 2)
    cohort = [0, 1, 3]
    jstate = jtd.DistTamunaState(
        x=_unflat(treedef, x0), h=_unflat(treedef, h0),
        opt=jopt.adamw(0.05).init(_unflat(treedef, x0)),
        round=jnp.zeros((), jnp.int32), up_floats=jnp.float32(0),
        down_floats=jnp.float32(0))
    jlocal = jax.jit(jtd.make_local_step(jcfg, jtd.DistTamunaConfig(**kw)))
    tcfg = tamuna_dp.DistTamunaConfig(**kw)
    state = _port_state(cfg, tcfg, names, x0, h0)
    local = tamuna_dp.make_local_step(cfg, tcfg)
    jcompact = jtd.gather_cohort(jstate, jnp.asarray(cohort))
    compact = tamuna_dp.gather_cohort(state, cohort)
    for t in range(2):
        toks = rng.integers(0, jcfg.vocab, size=(c, 2, 9)).astype(np.int32)
        jcompact, jm = jlocal(jcompact, tokens=jnp.asarray(toks[..., :-1]),
                              labels=jnp.asarray(toks[..., 1:]))
        tk = torch.from_numpy(toks).long()
        m = local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-6
    jstate = jtd.scatter_cohort(jstate, jcompact, jnp.asarray(cohort))
    state = tamuna_dp.scatter_cohort(state, compact)
    assert state.opt.count == int(jstate.opt.count) == 2
    spec = state.spec
    for got_ws, want, tol in ((state.x, jstate.x, 1e-5),
                              (state.opt.mu, jstate.opt.mu, 1e-6),
                              (state.opt.nu, jstate.opt.nu, 1e-6)):
        got = comm_ws.unpack(got_ws, spec)
        for k, w in zip(names, jax.tree.leaves(want)):
            assert np.abs(got[k].numpy() - np.asarray(w)).max() <= tol, k
    # the idle row is untouched, moments included
    assert not state.opt.mu[2].any() and not state.opt.nu[2].any()


def _port_state(cfg, tcfg, names, x0, h0):
    spec = tamuna_dp.state_spec(cfg, tcfg)
    n = x0[0].shape[0]
    x = torch.empty(n, spec.d_total)
    h = torch.empty(n, spec.d_total)
    comm_ws.pack({k: torch.from_numpy(a) for k, a in zip(names, x0)}, spec, x)
    comm_ws.pack({k: torch.from_numpy(a) for k, a in zip(names, h0)}, spec, h)
    opt = ()
    if tcfg.local_opt == "adamw":
        from repro_torch.optim import optimizers
        opt = optimizers.AdamState(torch.zeros_like(x), torch.zeros_like(x),
                                   0)
    return tamuna_dp.DistTamunaState(x=x, h=h, spec=spec, opt=opt)


# --------------------------------------------------------------------------
# reduced rounds: the reference's per-step composition
# --------------------------------------------------------------------------


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def reduced():
    jcfg, cfg = _configs()
    names, treedef, x0, h0, rng = _start(jcfg, N, 7)
    toks = rng.integers(0, jcfg.vocab, size=(L, N, BATCH, SEQ + 1)
                        ).astype(np.int32)
    key = jax.random.key_data(jax.random.key(11))
    _, k2 = jax.random.split(jax.random.wrap_key_data(key))
    return dict(jcfg=jcfg, cfg=cfg, names=names, treedef=treedef, x0=x0,
                h0=h0, toks=toks, key=key,
                perm=np.asarray(jax.random.permutation(k2, C)),
                off=int(jax.random.randint(k2, (), 0, C, jnp.int32)),
                locals={}, trained={})


# local steps of each option's round (module docstring: AdamW takes one)
STEPS = {"adamw": 1}
OPTIONS = {
    "adamw": dict(local_opt="adamw", microbatches=2),
    "block_rs": dict(uplink="block_rs"),
    "all_rows": dict(),
    "ws": dict(comm_impl="ws"),
    "dense": dict(comm_impl="dense"),
}


def _reference_round(ref, option):
    kw = dict(gamma=0.05, c=C, s=S, p=0.34, **OPTIONS[option])
    jt = jtd.DistTamunaConfig(**kw)
    elastic = option != "all_rows"
    lkey = (jt.local_opt, jt.microbatches, elastic)
    if lkey not in ref["trained"]:
        x, h = _unflat(ref["treedef"], ref["x0"]), _unflat(ref["treedef"],
                                                          ref["h0"])
        opt = jopt.adamw(0.05).init(x) if jt.local_opt == "adamw" else ()
        zero = jnp.zeros((), jnp.float32)
        state = jtd.DistTamunaState(
            x=x, h=h, opt=opt, round=jnp.zeros((), jnp.int32),
            up_floats=zero, down_floats=zero, up_bytes=zero,
            down_bytes=zero)
        local = jax.jit(jtd.make_local_step(ref["jcfg"], jt))
        rows = COHORT if elastic else list(range(N))
        cohort = jnp.asarray(rows, jnp.int32)
        work = jtd.gather_cohort(state, cohort) if elastic else state
        prev = None
        for t in range(STEPS.get(option, L)):
            tk = jnp.asarray(ref["toks"][t][np.asarray(rows)])
            work, _ = local(work, tokens=tk[..., :-1], labels=tk[..., 1:])
            if jt.local_opt == "adamw":
                # each step's g - h from the first moment's update, and the
                # coordinates where it lies near 0 (for rows ``rows``)
                mu = [np.asarray(a, np.float64)
                      for a in jax.tree.leaves(work.opt.mu)]
                eff = [(m if p is None else m - 0.9 * p) / 0.1
                       for m, p in zip(mu, prev or [None] * len(mu))]
                near = [np.abs(e) <= 1e-5 for e in eff]
                acc = ref.setdefault("near0", [np.zeros((N,) + a.shape[1:],
                                                        bool) for a in mu])
                for a, nr in zip(acc, near):
                    a[np.asarray(rows)] |= nr
                prev = mu
        state = (jtd.scatter_cohort(state, work, cohort) if elastic
                 else work)
        ref["trained"][lkey] = state
    state = ref["trained"][lkey]
    comm = jax.jit(jtd.make_comm_step(
        ref["jcfg"], dataclasses.replace(
            jt, comm_impl=jt.comm_impl if jt.comm_impl != "auto" else "ws"),
        _mesh(), n=N))
    return comm(state, ref["key"], cohort=jnp.asarray(COHORT, jnp.int32),
                down=None if not elastic else jnp.asarray(DOWN))


def _port_round(ref, option):
    kw = dict(gamma=0.05, c=C, s=S, p=0.34, **OPTIONS[option])
    tcfg = tamuna_dp.DistTamunaConfig(**kw)
    cfg = ref["cfg"]
    elastic = option != "all_rows"
    state = _port_state(cfg, tcfg, ref["names"], ref["x0"], ref["h0"])
    local = tamuna_dp.make_local_step(cfg, tcfg)
    rows = COHORT if elastic else list(range(N))
    compact = tamuna_dp.gather_cohort(state, rows)
    for t in range(STEPS.get(option, L)):
        tk = torch.from_numpy(ref["toks"][t][np.asarray(rows)]).long()
        local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
    state = tamuna_dp.scatter_cohort(state, compact)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, N, device="cpu")
    tmpl = (dict(off=ref["off"]) if tcfg.uplink == "block_rs"
            else dict(perm=ref["perm"].tolist()))
    return comm(state, COHORT, down=torch.from_numpy(DOWN) if elastic
                else None, **tmpl)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_reduced_round_option_matches_reference(reduced, option):
    want = _reference_round(reduced, option)
    got = _port_round(reduced, option)
    spec = got.spec
    pairs = [(got.x, want.x), (got.h, want.h)]
    near0 = {}
    if option == "adamw":
        pairs += [(got.opt.mu, want.opt.mu), (got.opt.nu, want.opt.nu)]
        assert got.opt.count == int(want.opt.count) == 1
        # a coordinate near 0 in any cohort row reaches x_bar, hence every
        # row's x and the owners' h at that coordinate
        near0 = {k: np.broadcast_to(v.any(axis=0, keepdims=True), v.shape)
                 for k, v in zip(reduced["names"], reduced["near0"])}
        frac = (sum(int(v.sum()) for v in near0.values())
                / sum(v.size for v in near0.values()))
        assert frac < 5e-3, frac
        scale = tamuna_dp.DistTamunaConfig(
            gamma=0.05, c=C, s=S, p=0.34).eta_(N) / 0.05
    for ws, tree in pairs:
        gv = comm_ws.unpack(ws, spec)
        for k, w in zip(reduced["names"], jax.tree.leaves(tree)):
            diff = np.abs(gv[k].numpy() - np.asarray(w))
            if k in near0 and ws is not got.opt.mu and ws is not got.opt.nu:
                # x and the h update (which reads x) near g - h = 0
                # an AdamW step moves x by at most gamma (1 + a few ulp)
                bound = 2 * 0.05 * (1.0 if ws is got.x else 2 * scale) + 1e-5
                assert diff[near0[k]].max(initial=0.0) <= bound, (option, k)
                diff = diff[~near0[k]]
            err = diff.max(initial=0.0)
            assert err <= 1e-5, (option, k, err)
    assert got.round == int(want.round) == 1
    for k in ("up_floats", "down_floats", "up_bytes", "down_bytes"):
        w = float(getattr(want, k))
        assert abs(float(getattr(got, k)) - w) <= 1e-5 * w, k
    if option == "all_rows":
        # every row trained and every row received x_bar
        assert all(torch.equal(got.x[i], got.x[0]) for i in range(1, N))


def test_run_rounds_all_rows_equals_its_composition():
    cfg = registry.get_reduced_config("gemma2-2b")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34)

    def fresh():
        return tamuna_dp.init_state(cfg, tcfg, N, seed=0, device="cpu")

    def pipe():
        return SyntheticTokenPipeline(
            DataConfig(seq_len=16, per_client_batch=2, vocab=512, seed=0,
                       n_clients=N), cfg, "cpu")

    state, rows_ = rounds.run_rounds(
        fresh(), cfg=cfg, tcfg=tcfg, pipe=pipe(), rounds=1,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=2, elastic=False)
    # the same round composed by hand with run_rounds' draws
    gen = torch.Generator().manual_seed(1)
    L_ = tamuna_dp.sample_round_length(np.random.default_rng(0), tcfg.p,
                                       max_L=2)
    perm = torch.randperm(C, generator=gen).tolist()
    cohort = rounds.uniform_cohort(gen.initial_seed(), N, C, 0)
    want = fresh()
    p = pipe()
    compact = tamuna_dp.gather_cohort(want, range(N))
    local = tamuna_dp.make_local_step(cfg, tcfg)
    for _ in range(L_):
        local(compact, **p.sample_batch(np.arange(N)))
    comm = tamuna_dp.make_comm_step(cfg, tcfg, N, device="cpu")
    want = comm(tamuna_dp.scatter_cohort(want, compact), cohort, perm)
    assert rows_[0]["L"] == L_
    assert torch.equal(state.x, want.x) and torch.equal(state.h, want.h)
    assert all(torch.equal(state.x[i], state.x[0]) for i in range(1, N))


# --------------------------------------------------------------------------
# validation
# --------------------------------------------------------------------------

BAD = [
    dict(s=1), dict(s=4), dict(wire_precision="fp8"),
    dict(wire_down=True), dict(uplink="ring"), dict(comm_impl="cuda"),
    dict(local_opt="lion"), dict(use_kernel=True, local_opt="adamw"),
    dict(robust_agg="mode"), dict(robust_agg="trimmed", trim_k=1),
]


@pytest.mark.parametrize("bad", BAD)
def test_config_validation_matches_reference(bad):
    kw = dict(gamma=0.05, c=3, s=2, p=0.34)
    kw.update(bad)
    with pytest.raises(ValueError) as want:
        jtd.DistTamunaConfig(**kw)
    with pytest.raises(ValueError) as got:
        tamuna_dp.DistTamunaConfig(**kw)
    assert str(got.value) == str(want.value)


def test_every_reference_option_is_accepted():
    for kw in (dict(uplink="block_rs"), dict(local_opt="adamw"),
               dict(microbatches=4), dict(use_kernel=True),
               *[dict(comm_impl=i) for i in tamuna_dp.COMM_IMPLS]):
        cfg = dict(gamma=0.05, c=3, s=2, p=0.34, **kw)
        jtd.DistTamunaConfig(**cfg)
        tamuna_dp.DistTamunaConfig(**cfg)
    assert set(f.name for f in dataclasses.fields(jtd.DistTamunaConfig)) \
        == set(f.name for f in dataclasses.fields(tamuna_dp.DistTamunaConfig))
    with pytest.raises(ValueError, match="microbatches"):
        tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34,
                                   microbatches=0)
