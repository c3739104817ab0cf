"""The five examples as port scripts (``repro_torch.examples``), on the CPU.

Each example's ``main(argv)`` runs in this process at small arguments and
must return 0 and print its table.  The three convex examples
(``quickstart``, ``federated_sim``'s c/s sweep, ``availability_sim``'s
crossover) print the reference scripts' tables: the reference's functions
run in a subprocess (its convex core needs jax x64) at ROUNDS rounds, the
draws of each of their runs are recorded there and injected into the
port's, and the printed text, the traces and the simulated clocks must
match.  ``availability_sim``'s latency model (numpy, copied from the
reference's ``examples/availability_sim.py``) is held bit for bit against
the reference's on the inputs of ``tests/test_availability_sim.py``, and
its ``--dist-out`` export is read by both packages'
``EmpiricalDelays.from_json`` with the same samples and the same per-round
draws.

The LM examples (``federated_sim --lm``, ``availability_sim --dist``,
``train_lm``, ``serve_decode``) are not compared number for number: the
reference draws their weights and batches from jax's threefry streams,
which the port replaces by its own seeded streams, and the scripts take no
injected weights or batches.  The modules they drive are held against the
reference in their own tests.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro.dist import faults as jfaults
from repro_torch.core import baselines, compression, tamuna
from repro_torch.dist import faults
from repro_torch.examples import (availability_sim, federated_sim,
                                  quickstart, serve_decode, train_lm)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 330  # federated_sim's s = 4 rows reach its target at round 326

# The reference scripts' convex functions at ROUNDS rounds: every
# ``tamuna.run`` and ``baselines.run_scaffold`` they make is cut to ROUNDS
# rounds and records its draws (cohort, L and permutation of each round,
# as ``round_step`` splits them from the run's round keys), its trace, and
# ``simulate``'s clock; their printed text is kept.
REFERENCE = r'''
import contextlib, importlib.util, io, json, sys
from functools import partial
import numpy as np
import jax, jax.numpy as jnp
from repro.core import baselines, compression, tamuna

R, OUT = int(sys.argv[1]), sys.argv[2]
out = {}


def load(name):
    spec = importlib.util.spec_from_file_location(name + "_reference", "examples/" + name + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def round_keys(seed):
    def body(key, _):
        key, rk = jax.random.split(key)
        return key, rk
    return jax.lax.scan(body, jax.random.key(seed), None, length=R)[1]


@partial(jax.jit, static_argnums=(3, 4))
@partial(jax.vmap, in_axes=(0, None, None, None, None))
def draw(rk, p, max_L, n, c):
    k_cohort, k_L, k_mask, _ = jax.random.split(rk, 4)
    cohort, _ = compression.split_cohort(k_cohort, n, c)
    u = jax.random.uniform(k_L, (), minval=1e-12, maxval=1.0)
    L = jnp.minimum(1 + jnp.floor(jnp.log(u) / jnp.log1p(-p)).astype(jnp.int32), max_L)
    return cohort, L, jax.random.permutation(k_mask, c)


run0, scaffold0 = tamuna.run, baselines.run_scaffold


def run(prob, cfg, num_rounds, seed=0, record_every=1, x0=None):
    assert cfg.geometric_L and not cfg.blocked_mask and seed == 0 and x0 is None
    tag = f"{prob.n}/{cfg.c}/{cfg.s}"
    for k, v in zip(("cohort", "L", "perm"), draw(round_keys(seed), cfg.p, cfg.max_L, prob.n, cfg.c)):
        out[f"draws/{tag}/{k}"] = np.asarray(v)
    tr = run0(prob, cfg, R, seed=seed, record_every=record_every)
    i = sum(k.startswith("tamuna/") for k in out) // 4  # runs in call order
    for k in ("rounds", "suboptimality", "up_floats", "local_steps"):
        out[f"tamuna/{i}/{k}"] = tr[k]
    return tr


def run_scaffold(prob, gamma, local_steps, c=None, num_rounds=100, seed=0, record_every=1):
    cohort = jax.vmap(lambda rk: compression.split_cohort(rk, prob.n, c)[0])
    out[f"cohorts/{prob.n}/{c}"] = np.asarray(cohort(round_keys(seed)))
    tr = scaffold0(prob, gamma, local_steps, c=c, num_rounds=R, seed=seed, record_every=record_every)
    out[f"scaffold/{prob.n}/{c}/suboptimality"] = tr["suboptimality"]
    return tr


tamuna.run, baselines.run_scaffold = run, run_scaffold
avail = load("availability_sim")
simulate0 = avail.simulate


def simulate(prob, c, seed=0, rounds=3000, straggler_frac=0.1):
    tr, clock = simulate0(prob, c, seed=seed, rounds=rounds, straggler_frac=straggler_frac)
    out[f"clock/{prob.n}/{c}"] = clock
    return tr, clock


avail.simulate = simulate
texts = {}
for name, fn in (("quickstart", lambda: load("quickstart").main()),
                 ("federated_sim", lambda: load("federated_sim").convex_sweep()),
                 ("availability_sim", lambda: avail.convex_main(R))):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    texts[name] = buf.getvalue()
np.savez(OUT, texts=json.dumps(texts), **out)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def reference_tables():
    """The reference scripts' convex functions (REFERENCE), started in a
    subprocess before the module's first test, so that it runs beside
    them, and read when ``.result()`` is called (by the last test)."""
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ROUNDS), path], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    class Result:
        def result(self):
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            with np.load(path) as z:
                return {k: z[k] for k in z.files}

    yield Result()
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    tmp.cleanup()


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "availability_sim_reference",
        os.path.join(REPO, "examples", "availability_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("module,argv,expect", [
    (quickstart, ["--rounds", "60"], "uplink floats to reach"),
    (federated_sim, ["--rounds", "30"], "Theorem 3 recommends s ="),
    (federated_sim, ["--lm", "--rounds", "1"], "UpCom/client"),
    (availability_sim, ["--rounds", "40"], "sim wall-clock"),
    (availability_sim, ["--dist", "--faults", "--rounds", "2"],
     "wait_all+drops"),
    (train_lm, ["--rounds", "2", "--seq-len", "16"], "done: the loss"),
    (serve_decode, ["--prompt-len", "4", "--gen-len", "3"],
     "qwen3-moe-30b-a3b: cache"),
])
def test_example_main_runs_on_the_cpu(module, argv, expect, capsys):
    assert module.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert expect in out, out[-2000:]
    assert "nan" not in out.lower(), out[-2000:]


def test_examples_run_on_the_card_by_default(monkeypatch):
    """No quiet fallback: without a card the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (quickstart, federated_sim, availability_sim, train_lm,
                   serve_decode):
        with pytest.raises(RuntimeError, match="GPU by default"):
            module.main([])


def test_latency_model_is_the_references_bit_for_bit():
    """``straggler_base`` and ``wallclock_per_round`` on the inputs of
    ``tests/test_availability_sim.py``: the same arrays, bit for bit."""
    ref = _reference_example()
    for n, frac, seed in ((1000, 0.1, 0), (8, 0.25, 0), (64, 0.1, 3)):
        a = availability_sim.straggler_base(n, np.random.default_rng(seed),
                                            frac)
        b = ref.straggler_base(n, np.random.default_rng(seed), frac)
        assert a.tobytes() == b.tobytes()
    base = np.ones(10)
    base[0] = 100.0
    steps = np.ones(200, int)
    for c in (10, 2):
        a = availability_sim.wallclock_per_round(
            steps, 10, c, base, np.random.default_rng(0))
        b = ref.wallclock_per_round(steps, 10, c, base,
                                    np.random.default_rng(0))
        assert a.tobytes() == b.tobytes()
    base = np.arange(1.0, 9.0)
    cohorts = [np.array([0, 1]) for _ in range(50)]
    sa, sb = [], []
    a = availability_sim.wallclock_per_round(
        np.full(50, 3), 8, 2, base, np.random.default_rng(1),
        cohorts=cohorts, samples_out=sa)
    b = ref.wallclock_per_round(np.full(50, 3), 8, 2, base,
                                np.random.default_rng(1), cohorts=cohorts,
                                samples_out=sb)
    assert a.tobytes() == b.tobytes() and sa == sb


def test_dist_out_is_read_by_both_packages(tmp_path, capsys):
    """``--dist --dist-out``: the JSON's samples, quantiles and per-round
    times, and both packages' ``EmpiricalDelays.from_json`` built from it
    draw the same per-round fleet latencies."""
    path = tmp_path / "lat.json"
    assert availability_sim.main(["--dist", "--rounds", "2", "--dist-out",
                                  str(path), "--device", "cpu"]) == 0
    assert "[dist-out]" in capsys.readouterr().out
    with open(path) as f:
        blob = json.load(f)
    samples = np.asarray(blob["per_step_latency_s"])
    assert samples.size > 0 and np.isfinite(samples).all()
    assert blob["n"] == 8 and len(blob["per_round_s"]) == 4
    assert blob["quantiles"]["p50"] == float(np.quantile(samples, 0.5))
    port = faults.EmpiricalDelays.from_json(str(path), n=8, seed=5)
    ref = jfaults.EmpiricalDelays.from_json(str(path), n=8, seed=5)
    assert np.array_equal(port.samples, ref.samples)
    assert np.array_equal(port.samples, samples)
    for rnd in range(4):
        assert np.array_equal(port.delays(rnd), ref.delays(rnd))


def test_convex_examples_print_the_references_tables(reference_tables,
                                                    monkeypatch):
    """``quickstart``, ``federated_sim``'s sweep and ``availability_sim``'s
    crossover at ROUNDS rounds with every run's draws (and Scaffold's
    cohorts) injected from the reference's: the same printed text (the
    reference's em dash aside), every trace's suboptimality within 1e-9
    relative with the same rounds, floats and local steps, and the same
    simulated clocks bit for bit."""
    ref = reference_tables.result()
    traces, clocks, scaffold = [], {}, {}
    run0, scaffold0 = tamuna.run, baselines.run_scaffold
    simulate0 = availability_sim.simulate

    def draw_round(cfg, n, seed, r):
        tag = f"draws/{n}/{cfg.c}/{cfg.s}"
        return (ref[f"{tag}/cohort"][r], int(ref[f"{tag}/L"][r]),
                ref[f"{tag}/perm"][r])

    def run(prob, cfg, **kw):
        tr = run0(prob, cfg, **kw)
        traces.append(tr)
        return tr

    def run_scaffold(prob, *args, **kw):
        tr = scaffold0(prob, *args, **kw)
        scaffold[f"{prob.n}/{kw['c']}"] = tr
        return tr

    def simulate(prob, c, **kw):
        tr, clock = simulate0(prob, c, **kw)
        clocks[f"{prob.n}/{c}"] = clock
        return tr, clock

    monkeypatch.setattr(tamuna, "draw_round", draw_round)
    monkeypatch.setattr(tamuna, "run", run)
    monkeypatch.setattr(compression, "split_cohort",
                        lambda seed, r, n, c: (ref[f"cohorts/{n}/{c}"][r],
                                               None))
    monkeypatch.setattr(baselines, "run_scaffold", run_scaffold)
    monkeypatch.setattr(availability_sim, "simulate", simulate)
    texts = json.loads(str(ref["texts"]))
    for name, module in (("quickstart", quickstart),
                         ("federated_sim", federated_sim),
                         ("availability_sim", availability_sim)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert module.main(["--rounds", str(ROUNDS), "--device",
                                "cpu"]) == 0
        assert buf.getvalue() == texts[name].replace("\u2014", "-"), name
    # 1 + 9 + 3 runs, in the reference's order
    assert len(traces) == 13 and len(clocks) == 3 and len(scaffold) == 1
    for i, tr in enumerate(traces):
        for k in ("rounds", "up_floats", "local_steps"):
            assert np.array_equal(tr[k], ref[f"tamuna/{i}/{k}"]), (i, k)
        want = ref[f"tamuna/{i}/suboptimality"]
        assert np.abs(tr["suboptimality"] - want).max() <= 1e-9 * want.max()
    for tag, clock in clocks.items():
        assert clock.tobytes() == ref[f"clock/{tag}"].tobytes(), tag
    want = ref["scaffold/64/16/suboptimality"]
    got = scaffold["64/16"]["suboptimality"]
    assert np.abs(got - want).max() <= 1e-9 * want.max()
