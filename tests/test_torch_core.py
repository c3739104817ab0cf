"""The port's convex core (``repro_torch.core``) against ``repro.core`` on
the same inputs, at small sizes (n <= 16, d <= 64).

``repro.core.{compression,problems,tamuna}`` turn on jax x64 for the whole
process, so everything of theirs runs in one subprocess per test module
(the ``reference`` fixture), which writes its inputs, draws and outputs to
an ``.npz``; the port is held against it here.  ``masks`` and ``theory``
leave x64 alone and are compared in this process.

Tolerances: the templates, the theory, the data and the counters agree
exactly; ``mu`` and ``L`` (the port's ``m x m`` Gram against the
reference's ``d x d`` one) and ``f*`` within 1e-12 relative, ``x*`` within
1e-10 (different Newton solves); 50 rounds of ``round_step`` with the
reference's draws injected within 1e-10 relative for ``x_bar`` and ``h``
(the gradients are a closed form here and autograd there, and XLA may
contract the local step into FMAs: a few roundings per step).
"""

import os

import numpy as np
import pytest
import torch

from repro.core import masks as jmasks
from repro.core import theory as jtheory
from repro_torch import convert
from repro_torch.core import compression, masks, problems, tamuna, theory
from repro_torch.kernels import _build

ROUNDS = 50

# name -> the reference's constructor and its keyword arguments
PROBLEMS = {
    # n m >= d: Newton solves with the d x d Hessian
    "logreg": ("logreg", dict(n=12, d=40, samples_per_client=4, kappa=100.0,
                              seed=3)),
    # n m < d (real-sim's regime): Newton solves over the sample Gram
    "logreg_wide": ("logreg", dict(n=8, d=64, samples_per_client=2,
                                   kappa=100.0, seed=4)),
    "quad": ("quad", dict(n=16, d=32, kappa=50.0, seed=5)),
    "quad_thin": ("quad", dict(n=16, d=4, kappa=20.0, seed=6)),
}
# name -> (problem, TamunaConfig.tuned overrides)
CONFIGS = {
    "cyclic": ("logreg", dict(c=6)),
    "tall_thin": ("quad_thin", dict(c=12, s=2)),  # d s = 8 < c
    "blocked": ("logreg_wide", dict(c=5, blocked_mask=True)),
    "quant8": ("logreg", dict(c=6, quantize_bits=8)),
    "sigma": ("quad", dict(c=8, sigma=0.05)),
}

REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import compression, problems, tamuna

PROBLEMS, CONFIGS, ROUNDS = json.loads(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3])
out = {}

def closure(fn):
    f = fn.__wrapped__
    return dict(zip(f.__code__.co_freevars, (c.cell_contents for c in f.__closure__)))

probs = {}
for name, (kind, kw) in PROBLEMS.items():
    make = problems.make_logreg_problem if kind == "logreg" else problems.make_quadratic_problem
    prob = make(**kw)
    probs[name] = prob
    cells = closure(prob.grad_cohort)
    if kind == "logreg":
        out[f"{name}/A"], out[f"{name}/b"] = np.asarray(cells["A_j"]), np.asarray(cells["b_j"])
    else:
        out[f"{name}/diag"], out[f"{name}/t"] = np.asarray(cells["diag_j"]), np.asarray(cells["t_j"])
    out[f"{name}/consts"] = np.array([prob.mu, prob.L, prob.f_star])
    out[f"{name}/x_star"] = np.asarray(prob.x_star)
    X = np.random.default_rng(7).normal(size=(prob.n, prob.d))
    out[f"{name}/X"] = X
    out[f"{name}/f"] = np.array(float(prob.f(jnp.asarray(X[0]))))
    out[f"{name}/grads"] = np.asarray(prob.grad_all_local(jnp.asarray(X)))

# compression: the quantizer with its uniforms drawn from a key, the mask
# aggregation and the byte accounting
v = np.random.default_rng(8).normal(size=(3, 600)) * np.array([[1.0], [1e-3], [50.0]])
v[0, 7], v[1, 300], v[2, 599] = np.inf, np.nan, -np.inf
v[1, 512:] = 0.0
for bits in (8, 4):
    key = jax.random.key(bits)
    out[f"quant/{bits}/rnd"] = np.asarray(jax.random.uniform(key, v.shape))
    out[f"quant/{bits}/out"] = np.asarray(compression.quantize_stochastic(key, jnp.asarray(v), bits))
out["quant/v"] = v
xs = np.random.default_rng(9).normal(size=(6, 40))
q = (np.random.default_rng(10).random((40, 6)) < 0.4).astype(np.int8)
out["agg/xs"], out["agg/q"] = xs, q
out["agg/out"] = np.asarray(compression.aggregate_masked(jnp.asarray(xs), jnp.asarray(q), 3))
out["bytes"] = np.array([compression.uplink_bytes_permutation(d, c, s, kind)
                         for d in (40, 1000, 20958) for c, s in ((6, 2), (100, 3))
                         for kind in ("f32", "bf16", "f16", "int8", "int4")])

# 50 rounds of round_step per config, with the draws it makes
for name, (pname, over) in CONFIGS.items():
    prob = probs[pname]
    cfg = tamuna.TamunaConfig.tuned(prob, **over)
    n, d, c = prob.n, prob.d, cfg.c
    out[f"{name}/cfg"] = np.array([cfg.gamma, cfg.eta, cfg.p, cfg.c, cfg.s])
    step = jax.jit(lambda st, k: tamuna.round_step(prob, cfg, st, k))

    @jax.jit
    def draws(rk):
        k_cohort, k_L, k_mask, k_grad = jax.random.split(rk, 4)
        cohort, _ = compression.split_cohort(k_cohort, n, c)
        u = jax.random.uniform(k_L, (), minval=1e-12, maxval=1.0)
        L = jnp.minimum(1 + jnp.floor(jnp.log(u) / jnp.log1p(-cfg.p)).astype(jnp.int32), cfg.max_L)
        perm = jax.random.permutation(k_mask, c)
        qkeys = jax.random.split(jax.random.fold_in(k_mask, 7), c)
        qrnd = jax.vmap(lambda kk: jax.random.uniform(kk, (d,)))(qkeys)
        return cohort, L, perm, qrnd, k_grad

    state = tamuna.init(prob)
    key = jax.random.key(0)
    rec = {k: [] for k in ("cohort", "L", "perm", "qrnd", "noise", "x_bar", "h", "counters")}
    for r in range(ROUNDS):
        key, rk = jax.random.split(key)
        cohort, L, perm, qrnd, k = draws(rk)
        for _ in range(int(L)):
            k, gk = jax.random.split(k)
            if cfg.sigma > 0:
                rec["noise"].append(np.asarray(jax.random.normal(gk, (c, d), jnp.float64)))
        state = step(state, rk)
        rec["cohort"].append(np.asarray(cohort))
        rec["L"].append(int(L))
        rec["perm"].append(np.asarray(perm))
        if cfg.quantize_bits:
            rec["qrnd"].append(np.asarray(qrnd))
        rec["x_bar"].append(np.asarray(state.x_bar))
        rec["h"].append(np.asarray(state.h))
        rec["counters"].append([int(state.round), int(state.total_local_steps),
                                float(state.up_floats), float(state.down_floats)])
    for k, vals in rec.items():
        if vals:
            out[f"{name}/{k}"] = np.asarray(vals)
np.savez(sys.argv[4], **out)
'''


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import json
    import subprocess
    import sys

    path = str(tmp_path_factory.mktemp("core") / "reference.npz")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps(PROBLEMS),
         json.dumps(CONFIGS), str(ROUNDS), path],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _port_problem(ref, name):
    kind = PROBLEMS[name][0]
    keys = ("A", "b") if kind == "logreg" else ("diag", "t")
    mu, L, f_star = ref[f"{name}/consts"]
    return convert.convex_problem_from_numpy(
        {k: ref[f"{name}/{k}"] for k in keys}, mu=mu, L=L,
        x_star=ref[f"{name}/x_star"], f_star=f_star, device="cpu")


# -- masks and theory: in this process, exact ---------------------------------

@pytest.mark.parametrize("d,c,s", [(20, 6, 2), (7, 7, 3), (3, 10, 2),
                                   (23, 5, 3), (1, 4, 4)])
def test_templates_match_reference(d, c, s):
    np.testing.assert_array_equal(masks.template_mask(d, c, s),
                                  jmasks.template_mask(d, c, s))
    np.testing.assert_array_equal(masks.block_template_mask(d, c, s),
                                  jmasks.block_template_mask(d, c, s))


@pytest.mark.parametrize("d,c,s,blocked", [
    (20, 6, 2, False),  # cyclic, d s >= c
    (3, 10, 2, False),  # tall-and-thin, d s < c
    (23, 5, 3, True),  # blocked, ragged last chunk
    (4, 9, 2, True),  # blocked with more columns than chunks
])
def test_mask_from_permutation_matches_reference(d, c, s, blocked):
    import jax.numpy as jnp

    perm = np.random.default_rng(d * c).permutation(c).astype(np.int32)
    want = np.asarray(jmasks.mask_from_permutation(jnp.asarray(perm), d, c,
                                                   s, blocked=blocked))
    got = masks.mask_from_permutation(torch.from_numpy(perm), d, c, s,
                                      blocked=blocked)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # the permuted template: column i is template column perm[i]
    tmpl = (jmasks.block_template_mask if blocked
            else jmasks.template_mask)(d, c, s)
    np.testing.assert_array_equal(got.numpy(), tmpl[:, perm])
    assert (got.sum(dim=1) == s).all()  # exactly s owners per coordinate


def test_mask_helpers_match_reference():
    for off, c, s in ((0, 5, 2), (3, 7, 3), (11, 4, 4)):
        np.testing.assert_array_equal(
            masks.block_shift_permutation(off, c, s).numpy(),
            np.asarray(jmasks.block_shift_permutation(off, c, s)))
    for d, c, s in ((20, 6, 2), (3, 10, 2), (20958, 100, 2), (1, 1000, 2)):
        assert masks.column_nnz(d, c, s) == jmasks.column_nnz(d, c, s)
        assert (masks.block_column_nnz(d, c, s)
                == jmasks.block_column_nnz(d, c, s))
    k = np.arange(40)
    np.testing.assert_array_equal(masks.owner_band_start(k, 40, 7, 3),
                                  jmasks.owner_band_start(k, 40, 7, 3))
    with pytest.raises(ValueError):
        masks.mask_from_permutation(torch.arange(4), 5, 4, 1)


def test_port_draws_are_seeded_permutations_and_cohorts():
    p = masks.sample_permutation(0, 3, 100)
    assert sorted(p.tolist()) == list(range(100))
    assert np.array_equal(p, masks.sample_permutation(0, 3, 100))
    assert not np.array_equal(p, masks.sample_permutation(0, 4, 100))
    idx, member = compression.split_cohort(0, 3, 50, 10)
    assert len(set(idx.tolist())) == 10 and member.sum() == 10
    assert member[idx].all()
    assert np.array_equal(idx, compression.split_cohort(0, 3, 50, 10)[0])
    q = masks.sample_mask(0, 3, 20, 6, 2)
    assert (q.sum(dim=1) == 2).all()


def test_theory_matches_reference_bitwise():
    names = ("theorem1_rate", "chi_max", "recommended_eta", "recommended_p",
             "recommended_s", "iteration_complexity", "upcom_complexity",
             "downcom_complexity", "totalcom_complexity", "gd_totalcom",
             "scaffnew_totalcom", "scaffold_totalcom")
    args = {
        "theorem1_rate": (0.003, 0.65, 6500.0, 0.22, 0.6, 1000, 2),
        "chi_max": (1000, 2), "recommended_eta": (0.22, 1000, 2),
        "recommended_p": (1000, 2, 1e4), "recommended_s": (100, 20958, 0.0),
        "iteration_complexity": (1e4, 1000, 2, 0.22),
        "upcom_complexity": (1e4, 1000, 100, 2, 20958, 0.22),
        "downcom_complexity": (1e4, 1000, 100, 2, 20958, 0.22),
        "totalcom_complexity": (1e4, 1000, 100, 2, 20958, 0.22, 0.1),
        "gd_totalcom": (1e4, 300, 0.1), "scaffnew_totalcom": (1e4, 300, 0.1),
        "scaffold_totalcom": (1e4, 300, 1000, 100, 0.1),
    }
    for name in names:
        assert getattr(theory, name)(*args[name]) == \
            getattr(jtheory, name)(*args[name]), name
    for c, alpha in ((100, 0.0), (1000, 0.0), (6, 0.5)):
        assert (theory.TunedParams.for_problem(0.65, 6500.0, 1000, c, 20958,
                                               alpha).__dict__
                == jtheory.TunedParams.for_problem(0.65, 6500.0, 1000, c,
                                                   20958, alpha).__dict__)


# -- the reference's subprocess -----------------------------------------------

@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_problem_matches_reference(ref, name):
    kind, kw = PROBLEMS[name]
    make = (problems.make_logreg_problem if kind == "logreg"
            else problems.make_quadratic_problem)
    prob = make(**kw, device="cpu")
    if kind == "logreg":
        assert prob.A.numpy().tobytes() == ref[f"{name}/A"].tobytes()
        assert prob.b.numpy().tobytes() == ref[f"{name}/b"].tobytes()
    else:
        assert prob.diag.numpy().tobytes() == ref[f"{name}/diag"].tobytes()
        assert prob.t.numpy().tobytes() == ref[f"{name}/t"].tobytes()
    mu, L, f_star = ref[f"{name}/consts"]
    assert abs(prob.mu - mu) <= 1e-12 * mu
    assert abs(prob.L - L) <= 1e-12 * L
    assert _rel(prob.x_star, ref[f"{name}/x_star"]) <= 1e-10
    assert abs(prob.f_star - f_star) <= 1e-12 * abs(f_star)
    # the loss and the per-client gradients at a random point
    X = torch.from_numpy(ref[f"{name}/X"])
    assert abs(float(prob.f(X[0])) - float(ref[f"{name}/f"])) <= \
        1e-12 * abs(float(ref[f"{name}/f"]))
    assert _rel(prob.grad_all_local(X), ref[f"{name}/grads"]) <= 1e-12
    if kind == "logreg":
        assert float(prob.grad(prob.x_star).norm()) < 1e-13


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_stochastic_matches_reference(ref, bits):
    v = torch.from_numpy(ref["quant/v"])
    got = compression.quantize_stochastic(
        v, bits, torch.from_numpy(ref[f"quant/{bits}/rnd"]))
    want = ref[f"quant/{bits}/out"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_compression_helpers_match_reference(ref):
    got = compression.aggregate_masked(torch.from_numpy(ref["agg/xs"]),
                                       torch.from_numpy(ref["agg/q"]), 3)
    assert _rel(got, ref["agg/out"]) <= 1e-15
    col = torch.from_numpy(ref["agg/q"][:, 2])
    np.testing.assert_array_equal(
        compression.apply_mask(torch.from_numpy(ref["agg/xs"][2]), col),
        ref["agg/xs"][2] * ref["agg/q"][:, 2])
    got = [compression.uplink_bytes_permutation(d, c, s, kind)
           for d in (40, 1000, 20958) for c, s in ((6, 2), (100, 3))
           for kind in ("f32", "bf16", "f16", "int8", "int4")]
    np.testing.assert_array_equal(np.array(got), ref["bytes"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_round_step_matches_reference_for_50_rounds(ref, name):
    pname, over = CONFIGS[name]
    prob = _port_problem(ref, pname)
    cfg = tamuna.TamunaConfig.tuned(prob, **over)
    assert [cfg.gamma, cfg.eta, cfg.p, cfg.c, cfg.s] == \
        ref[f"{name}/cfg"].tolist()
    state = tamuna.init(prob)
    noise = ref.get(f"{name}/noise")
    used = 0
    for r in range(ROUNDS):
        L = int(ref[f"{name}/L"][r])
        qrnd = (torch.from_numpy(ref[f"{name}/qrnd"][r])
                if cfg.quantize_bits else None)
        state = tamuna.round_step(
            prob, cfg, state, ref[f"{name}/cohort"][r], L,
            ref[f"{name}/perm"][r],
            noise=(lambda l, o=used: torch.from_numpy(noise[o + l]))
            if cfg.sigma > 0 else None, qrnd=qrnd)
        used += L if cfg.sigma > 0 else 0
        assert _rel(state.x_bar, ref[f"{name}/x_bar"][r]) <= 1e-10, r
        assert _rel(state.h, ref[f"{name}/h"][r]) <= 1e-10, r
        assert [state.round, state.total_local_steps, state.up_floats,
                state.down_floats] == ref[f"{name}/counters"][r].tolist()
    assert noise is None or used == len(noise)


def test_state_carries_over_from_reference(ref):
    prob = _port_problem(ref, "logreg")
    cfg = tamuna.TamunaConfig.tuned(prob, c=6)
    r = 30  # resume the reference's run after round 30 in the port
    cnt = ref["cyclic/counters"][r - 1]
    state = convert.tamuna_state_from_numpy(
        ref["cyclic/x_bar"][r - 1], ref["cyclic/h"][r - 1], *cnt,
        device="cpu")
    state = tamuna.round_step(prob, cfg, state, ref["cyclic/cohort"][r],
                              int(ref["cyclic/L"][r]), ref["cyclic/perm"][r])
    assert _rel(state.x_bar, ref["cyclic/x_bar"][r]) <= 1e-12
    assert _rel(state.h, ref["cyclic/h"][r]) <= 1e-12
    assert state.round == r + 1


# -- the port alone -----------------------------------------------------------

def test_cyclic_round_through_compress_equals_the_mask_form():
    """The kernel path (the cyclic template, C_i as compress) and the mask
    form of the same template agree bitwise on finite data."""
    prob = problems.make_logreg_problem(n=10, d=30, samples_per_client=3,
                                        kappa=50.0, device="cpu")
    cfg = tamuna.TamunaConfig.tuned(prob, c=7, s=3)
    cohort, L, perm = tamuna.draw_round(cfg, prob.n, 0, 0)
    s1 = tamuna.init(prob, x0=torch.linspace(-1, 1, 30, dtype=torch.float64))
    s1.h.normal_(generator=torch.Generator().manual_seed(0))
    s2 = tamuna.TamunaState(s1.x_bar.clone(), s1.h.clone())
    before = dict(_build.launch_counts)
    a = tamuna.round_step(prob, cfg, s1, cohort, L, perm)
    assert _build.launch_counts == before  # the CPU runs the plain version
    # the mask form of the cyclic template, written out
    c, s = cfg.c, cfg.s
    ct = torch.from_numpy(cohort)
    X = s2.x_bar.expand(c, prob.d)
    for _ in range(L):
        X = X - cfg.gamma * prob.grad_cohort(X, ct) + cfg.gamma * s2.h[ct]
    q = masks.mask_from_permutation(torch.from_numpy(perm), prob.d, c, s)
    x_bar = compression.aggregate_masked(X, q, s)
    s2.h.index_add_(0, ct, cfg.eta / cfg.gamma * q.T.double()
                    * (x_bar[None, :] - X))
    assert torch.equal(a.x_bar, x_bar)
    assert torch.equal(a.h, s2.h)


def test_run_converges_to_the_exact_solution():
    prob = problems.make_quadratic_problem(n=16, d=32, kappa=50,
                                           device="cpu")
    cfg = tamuna.TamunaConfig.tuned(prob, c=8)
    tr = tamuna.run(prob, cfg, num_rounds=2000, record_every=200)
    assert tr["suboptimality"][-1] < 1e-9
    assert list(tr["rounds"]) == list(range(1, 2001, 200)) + [2000]
    assert tr["lyapunov"][-1] < tr["lyapunov"][0]
    h = tr["state"].h
    assert float(h.sum(dim=0).abs().max()) < 1e-8  # sum_i h_i = 0
    # the same seed draws the same schedule
    again = tamuna.run(prob, cfg, num_rounds=20, record_every=20)
    first = tamuna.run(prob, cfg, num_rounds=20, record_every=20)
    assert torch.equal(again["state"].h, first["state"].h)
    assert again["local_steps"][-1] == sum(
        tamuna.sample_L(cfg, 0, r) for r in range(20))


def test_run_takes_an_injected_schedule_and_noise():
    prob = problems.make_quadratic_problem(n=8, d=16, kappa=10,
                                           device="cpu")
    cfg = tamuna.TamunaConfig.tuned(prob, c=4, sigma=0.01, quantize_bits=8)
    sched = [(np.array([0, 2, 4, 6]), 2, np.array([3, 0, 1, 2]))] * 5
    tr = tamuna.run(prob, cfg, 5, schedule=lambda r: sched[r])
    assert tr["local_steps"][-1] == 10
    h = tr["state"].h
    assert not h[1::2].any() and h[0::2].any()  # only the cohort moves
    assert np.isfinite(tr["suboptimality"]).all()
