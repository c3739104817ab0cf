"""The port's baselines (``repro_torch.core.baselines``), the rand-k and
top-k sparsifiers and the paper driver against the reference
(``repro.core.baselines``, ``repro.core.compression``), at a small size
(n = 8, d = 12, 4 samples each, kappa 100).

``repro.core`` turns on jax x64 for the whole process, so the reference
runs in one subprocess (the ``reference`` fixture): it records each
algorithm's draws as its jax keys make them (cohorts, communication
coins, mask permutations, rand-k indices) and its trace over 60 rounds
with ``record_every=1``.  The port runs each algorithm with those draws
injected.

Tolerances: ``rand_k``/``top_k`` (ties included: the lower index first)
and the float and byte counts are bitwise; each trace's suboptimality and
final state within 1e-10 relative (the gradients are a closed form here
and autograd there, the reference's jitted steps may multiply by a
constant's reciprocal where the port divides, and XLA may contract into
FMAs: a few roundings per round).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import baselines, compression, masks
from repro_torch.launch import paper_bench

ROUNDS = 60
PROBLEM = dict(n=8, d=12, samples_per_client=4, kappa=100.0, seed=5)
C, L_STEPS, S, P_COMM, K_RAND, K_TOP, INNER = 4, 3, 2, 0.3, 3, 2, 10

REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import baselines, compression, masks, problems

P = json.loads(sys.argv[1])
R, C, LS, S, PC, KR, KT, INNER = json.loads(sys.argv[2])
prob = problems.make_logreg_problem(**P)
f = prob.grad_cohort.__wrapped__
cells = dict(zip(f.__code__.co_freevars, (c.cell_contents for c in f.__closure__)))
out = {"A": np.asarray(cells["A_j"]), "b": np.asarray(cells["b_j"]),
       "consts": np.array([prob.mu, prob.L, prob.f_star]),
       "x_star": np.asarray(prob.x_star)}
n, d = prob.n, prob.d
gamma = 2.0 / (prob.L + prob.mu)

def round_keys(seed=0):
    key = jax.random.key(seed)
    for _ in range(R):
        key, rk = jax.random.split(key)
        yield rk

cohorts = np.stack([np.asarray(compression.split_cohort(rk, n, C)[0])
                    for rk in round_keys()])
coins, perms, idx = [], [], []
for rk in round_keys():
    k1, k2 = jax.random.split(rk)
    coins.append(bool(jax.random.bernoulli(k1, PC)))
    perms.append(np.asarray(masks.sample_permutation(k2, n)))
    keys = jax.random.split(rk, n)
    idx.append(np.stack([np.asarray(jax.random.choice(kk, d, shape=(KR,), replace=False))
                         for kk in keys]))
out.update(cohorts=cohorts, coins=np.array(coins), perms=np.stack(perms),
           indices=np.stack(idx))
runs = {
    "gd": lambda: baselines.run_gd(prob, gamma, R),
    "fedavg": lambda: baselines.run_fedavg(prob, gamma, LS, c=C, num_rounds=R),
    "scaffold": lambda: baselines.run_scaffold(prob, 0.5 * gamma, LS, c=C, num_rounds=R),
    "scaffnew": lambda: baselines.run_scaffnew(prob, gamma, PC, num_iters=R),
    "compressed_scaffnew": lambda: baselines.run_compressed_scaffnew(
        prob, gamma, PC, S, num_iters=R),
    "diana": lambda: baselines.run_diana(prob, 0.5 / prob.L, KR, num_rounds=R),
    "ef21": lambda: baselines.run_ef21(prob, 0.5 / prob.L, KT, num_rounds=R),
    "5gcs": lambda: baselines.run_5gcs(prob, 1.0 / np.sqrt(prob.mu * prob.L), C,
                                       inner_steps=INNER, num_rounds=R),
}
for name, run in runs.items():
    tr = run()
    for k in ("rounds", "suboptimality", "up_floats", "down_floats"):
        out[f"{name}/{k}"] = np.asarray(tr[k])
    out[f"{name}/x"] = np.asarray(tr["state"]["x"])

# the sparsifiers: rand-k with the key's indices, top-k with ties
v = np.random.default_rng(3).normal(size=(40,))
for j, k in enumerate((1, 7, 40)):
    key = jax.random.key(20 + j)
    out[f"randk/{k}/idx"] = np.asarray(jax.random.choice(key, 40, shape=(k,), replace=False))
    out[f"randk/{k}/out"] = np.asarray(compression.rand_k(key, jnp.asarray(v), k))
t = np.array([3.0, -3.0, 1.0, 3.0, 0.0, -1.0, 2.0, -2.0, -0.0, 3.0, 1e-300, -3.0])
for k in (1, 2, 4, 5, 9, 12):
    out[f"topk/{k}"] = np.asarray(compression.top_k(jnp.asarray(t), k))
    out[f"topk_v/{k}"] = np.asarray(compression.top_k(jnp.asarray(v), k))
out["randk_v"], out["topk_t"] = v, t
out["counts"] = np.array(
    [compression.uplink_floats_rand_k(k) for k in (1, 8, 300)]
    + [compression.uplink_bytes_rand_k(k, kind) for k in (1, 8, 300)
       for kind in ("f32", "bf16", "f16", "int8", "int4")])
np.savez(sys.argv[3], **out)
'''

ALGOS = ("gd", "fedavg", "scaffold", "scaffnew", "compressed_scaffnew",
         "diana", "ef21", "5gcs")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import subprocess
    import sys

    path = str(tmp_path_factory.mktemp("baselines") / "reference.npz")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    consts = [ROUNDS, C, L_STEPS, S, P_COMM, K_RAND, K_TOP, INNER]
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps(PROBLEM),
         json.dumps(consts), path],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def prob(reference):
    mu, L, f_star = reference["consts"]
    return convert.convex_problem_from_numpy(
        {"A": reference["A"], "b": reference["b"]}, mu=mu, L=L,
        x_star=reference["x_star"], f_star=f_star, device="cpu")


def _run(name, prob, ref):
    gamma = 2.0 / (prob.L + prob.mu)
    cohorts = [c for c in ref["cohorts"]]
    runs = {
        "gd": lambda: baselines.run_gd(prob, gamma, ROUNDS),
        "fedavg": lambda: baselines.run_fedavg(
            prob, gamma, L_STEPS, c=C, num_rounds=ROUNDS, cohorts=cohorts),
        "scaffold": lambda: baselines.run_scaffold(
            prob, 0.5 * gamma, L_STEPS, c=C, num_rounds=ROUNDS,
            cohorts=cohorts),
        "scaffnew": lambda: baselines.run_scaffnew(
            prob, gamma, P_COMM, num_iters=ROUNDS,
            coins=ref["coins"].tolist()),
        "compressed_scaffnew": lambda: baselines.run_compressed_scaffnew(
            prob, gamma, P_COMM, S, num_iters=ROUNDS,
            coins=ref["coins"].tolist(), perms=list(ref["perms"])),
        "diana": lambda: baselines.run_diana(
            prob, 0.5 / prob.L, K_RAND, num_rounds=ROUNDS,
            indices=list(ref["indices"])),
        "ef21": lambda: baselines.run_ef21(prob, 0.5 / prob.L, K_TOP,
                                           num_rounds=ROUNDS),
        "5gcs": lambda: baselines.run_5gcs(
            prob, 1.0 / np.sqrt(prob.mu * prob.L), C, inner_steps=INNER,
            num_rounds=ROUNDS, cohorts=cohorts),
    }
    return runs[name]()


@pytest.mark.parametrize("name", ALGOS)
def test_baseline_follows_the_reference_trace(reference, prob, name):
    got = _run(name, prob, reference)
    assert got["algo"] == name
    np.testing.assert_array_equal(got["rounds"],
                                  reference[f"{name}/rounds"])
    for k in ("up_floats", "down_floats"):
        np.testing.assert_array_equal(got[k], reference[f"{name}/{k}"])
    want = reference[f"{name}/suboptimality"]
    assert len(want) == ROUNDS
    # the trace moves: no algorithm sits at its start for 60 rounds
    assert want[-1] < want[0]
    np.testing.assert_allclose(got["suboptimality"], want, rtol=1e-10,
                               atol=0)
    x, wx = got["state"]["x"].numpy(), reference[f"{name}/x"]
    assert np.abs(x - wx).max() <= 1e-10 * np.abs(wx).max()


@pytest.mark.parametrize("k", [1, 7, 40])
def test_rand_k_matches_the_reference_bitwise(reference, k):
    v = torch.from_numpy(reference["randk_v"])
    got = compression.rand_k(v, k, reference[f"randk/{k}/idx"])
    assert got.numpy().tobytes() == reference[f"randk/{k}/out"].tobytes()
    # unbiased scale, k nonzeros; the port's own draw is seeded
    a = compression.rand_k(v, k, seed=3, r=5)
    assert int((a != 0).sum()) == k
    assert torch.equal(a, compression.rand_k(v, k, seed=3, r=5))
    batch = compression.rand_k(v.expand(3, 40), k, seed=3, r=5)
    assert torch.equal(batch[0], a) and not (
        k < 40 and torch.equal(batch[0], batch[1]))


@pytest.mark.parametrize("k", [1, 2, 4, 5, 9, 12])
def test_top_k_keeps_the_lower_index_on_ties(reference, k):
    t = torch.from_numpy(reference["topk_t"])
    got = compression.top_k(t, k)
    assert got.numpy().tobytes() == reference[f"topk/{k}"].tobytes()
    v = torch.from_numpy(reference["randk_v"])
    assert (compression.top_k(v, k).numpy().tobytes()
            == reference[f"topk_v/{k}"].tobytes())
    rows = compression.top_k(torch.stack([t, -t]), k)
    assert torch.equal(rows[0], got) and torch.equal(rows[1], -got)


def test_float_and_byte_counts_match_the_reference(reference):
    got = ([compression.uplink_floats_rand_k(k) for k in (1, 8, 300)]
           + [compression.uplink_bytes_rand_k(k, kind) for k in (1, 8, 300)
              for kind in ("f32", "bf16", "f16", "int8", "int4")])
    np.testing.assert_array_equal(np.array(got), reference["counts"])


def test_default_draws_are_the_ports_seeded_streams(prob):
    """Without a schedule each run draws from the port's numpy streams:
    the same seed gives the same trace, another seed another one."""
    gamma = 2.0 / (prob.L + prob.mu)
    runs = [baselines.run_compressed_scaffnew(prob, gamma, P_COMM, S,
                                              num_iters=30, seed=sd)
            for sd in (1, 1, 2)]
    assert np.array_equal(runs[0]["suboptimality"],
                          runs[1]["suboptimality"])
    assert not np.array_equal(runs[0]["suboptimality"],
                              runs[2]["suboptimality"])
    coins = [baselines.theta_coin(1, t, P_COMM) for t in range(30)]
    assert runs[0]["up_floats"][-1] == sum(coins) * masks.column_nnz(
        prob.d, prob.n, S)
    sched = compression.split_cohort(4, 7, prob.n, C)[0]
    a = baselines.run_5gcs(prob, 0.1, C, inner_steps=2, num_rounds=8,
                           seed=4)
    b = baselines.run_5gcs(prob, 0.1, C, inner_steps=2, num_rounds=8,
                           cohorts=lambda r: compression.split_cohort(
                               4, r, prob.n, C)[0])
    assert np.array_equal(a["suboptimality"], b["suboptimality"])
    assert len(sched) == C


def test_paper_bench_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "pb.json"
    assert paper_bench.main(["--only", "table2", "--smoke", "--device",
                             "cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and "fig3" not in res
    rows = res["table2"]["rows"]
    assert {r["algo"] for r in rows} == {
        "gd", "scaffnew", "compressed_scaffnew", "diana", "ef21", "tamuna"}
    assert all(np.isfinite(r["final_subopt"]) for r in rows)
    assert paper_bench.main(["--only", "table2", "--smoke", "--device",
                             "cpu", "--out",
                             str(tmp_path / "BENCH_paper.json")]) == 2


def test_floats_to_accuracy_is_the_references_accounting():
    tr = {"suboptimality": np.array([1.0, 0.5, 0.1, 0.2]),
          "up_floats": np.array([10, 20, 30, 40]),
          "down_floats": np.array([100, 200, 300, 400])}
    assert paper_bench.floats_to_accuracy(tr, 0.15, 0.1) == 60.0
    assert paper_bench.floats_to_accuracy(tr, 0.05, 0.0) is None
    np.testing.assert_array_equal(paper_bench.totalcom(tr, 0.5),
                                  [60.0, 120.0, 180.0, 240.0])
