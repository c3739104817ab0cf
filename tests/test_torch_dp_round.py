"""The data-parallel round (ROADMAP A9a) on gloo ranks on the CPU against
the port's one-process round, the ``--data-parallel`` CLI, and the paths
that are not ported over ranks (A9c, A9d), which raise.

* ``rounds.run_rounds(group=)`` on 2 ranks (``sharding.spawn``, one
  intra-op thread each): 3 rounds of the reduced gemma2-2b at n = 4, c =
  3, s = 2, x, h and every row's values bitwise with one process; and a
  ``[faults]``-shaped round (n = 5, c = 4, s = 3, a ``CohortPlan``, 25%
  drops, 20% NaN payloads, quorum, quarantine of 2 rounds, the guard's
  flags summed over the ranks), run as 2 + 1 rounds (two calls, which
  are one call bitwise): after round 1, whose comm step sums the ranks'
  partials and so reassociates each coordinate's three-term owner sum, x
  within 2 ulps of each leaf's largest |x| and h within ``scale`` (``eta
  / gamma``) times that and its own roundings; after 3 rounds every
  decision equal,
  losses within 1e-6 relative, sum_i h_i = 0 kept.  The later rounds are
  not held per coordinate: the local steps carry the first comm step's
  ulps into every leaf through the gradients (the state then differs by
  up to 15 ulps of a leaf's own largest value here, and by 2,278 ulps of
  the state's on the card at full width).
* ``python -m repro_torch.launch.train --data-parallel 2`` against
  ``--data-parallel 1``: the same logged rows and final loss.
* No fallback: ``--model-parallel 2`` on the MoE family (A9c),
  ``--dist-backend nccl`` on the CPU, ``--reputation`` and
  ``--checkpoint-dir`` over ranks exit with an error; nccl with more
  ranks than cards raises; the plain comm impls, the reputation,
  checkpoints and the pipelined driver with a group raise naming A9d; a
  rank that fails fails the spawn.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import cohort, faults, rounds, sharding, tamuna_dp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3
# name: (n, c, s, fault-tolerant round)
RUNS = {"train": (4, 3, 2, False), "faults": (5, 4, 3, True)}


def _run(name, group=None, first=ROUNDS):
    """``RUNS[name]``'s rounds of the reduced gemma2-2b on the CPU, on
    ``group``'s rows (every row when None), in two calls of ``run_rounds``
    when ``first < ROUNDS`` (the state, the streams and the plans carried
    over); returns the state's x and h rows after the first call and at
    the end, the metric rows without their host seconds, and the spec."""
    n, c, s, faulted = RUNS[name]
    cfg = registry.get_reduced_config("gemma2-2b")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=s, p=0.34)
    dev = torch.device("cpu")
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device=dev,
                                 rows=group)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=16, per_client_batch=1, vocab=min(cfg.vocab, 512),
                   seed=0, n_clients=n), cfg, dev)
    kw = dict(cfg=cfg, tcfg=tcfg, pipe=pipe, rng=np.random.default_rng(0),
              generator=torch.Generator().manual_seed(1), max_L=3,
              flush_every=2, group=group)
    if faulted:
        kw.update(plan=cohort.CohortPlan(0, n, c),
                  faults=faults.FaultPlan(seed=0, n=n, p_drop=0.25,
                                          p_corrupt=0.2, corrupt_mode="nan"),
                  policy="quorum", quarantine_rounds=2)
    state, rows = rounds.run_rounds(state, rounds=first, **kw)
    snap = (state.x.numpy().copy(), state.h.numpy().copy())
    if first < ROUNDS:
        state, more = rounds.run_rounds(state, rounds=ROUNDS - first, **kw)
        for row in more:  # each call counts its own local steps
            row["local_steps"] += rows[-1]["local_steps"]
        rows += more
    for row in rows:
        row.pop("seconds")
    return {"first": snap, "x": state.x.numpy().copy(),
            "h": state.h.numpy().copy(), "rows": rows, "spec": state.spec}


# the runs: (name, first call's rounds); the faulted ones split as
# chip_smoke.py's [faults_dp] is, its first round gated on its own
SPLIT = {"train": ROUNDS, "faults": 2}


def _rank_rounds(rank, dev, out_dir):
    torch.set_num_threads(1)
    out = {}
    for name, (n, *_) in RUNS.items():
        got = _run(name, sharding.RankRows.of_group(n), SPLIT[name])
        out[f"{name}/x"], out[f"{name}/h"] = got["x"], got["h"]
        out[f"{name}/x0"], out[f"{name}/h0"] = got["first"]
        out[f"{name}/rows"] = np.asarray(json.dumps(got["rows"]))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{name: (2 ranks' run, one process's run)}``, each as ``_run``
    returns it, the ranks' rows assembled in row order; the one-process
    faulted run also in one call (``"whole"``)."""
    tmp = str(tmp_path_factory.mktemp("dp_round"))
    sharding.spawn(_rank_rounds, 2, backend="gloo", device="cpu",
                   init_method=sharding.file_init_method(tmp), args=(tmp,))
    parts = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {name: _run(name, first=SPLIT[name]) for name in RUNS}
        one["whole"] = _run("faults")
    finally:
        torch.set_num_threads(threads)
    got = {}
    for name in RUNS:
        rows = [json.loads(str(p[f"{name}/rows"])) for p in parts]
        assert rows[0] == rows[1]  # every rank builds the same rows
        cat = {k: np.concatenate([p[f"{name}/{k}"] for p in parts])
               for k in ("x", "h", "x0", "h0")}
        got[name] = ({"first": (cat["x0"], cat["h0"]), "x": cat["x"],
                      "h": cat["h"], "rows": rows[0]}, one[name])
    got["whole"] = one["whole"]
    return got


def test_two_ranks_match_one_process_bitwise_at_s2(runs):
    dp, one = runs["train"]
    assert np.array_equal(dp["x"], one["x"])
    assert np.array_equal(dp["h"], one["h"])
    assert dp["rows"] == one["rows"]
    assert all(np.isfinite(r["loss"]) for r in dp["rows"])


def _ulp(v):
    return 2.0 ** (np.floor(np.log2(v)) - 23) if v > 0 else 2.0 ** -149


def test_run_rounds_in_two_calls_is_one_call(runs):
    """The split the faulted checks use: 2 + 1 rounds with the state,
    streams and plans carried over is the 3-round call, bitwise."""
    _, one = runs["faults"]
    whole = runs["whole"]
    assert np.array_equal(one["x"], whole["x"], equal_nan=True)
    assert np.array_equal(one["h"], whole["h"], equal_nan=True)
    assert one["rows"] == whole["rows"]


def test_faulted_two_ranks_within_two_ulps_per_leaf_after_round_1(runs):
    """Rounds 0-1 of the survivor round (s = 3): the comm steps sum the
    ranks' partials, which reassociates each coordinate's three-term owner
    sum (round 1's; round 0 here has at most two arrived owners a
    coordinate, so it stays bitwise): x within 2 ulps of each leaf's
    largest |x|, h within ``scale`` times that and the h update's own two
    roundings (2 ulps of the leaf's largest |h|); round 0's and round 1's
    losses (taken before round 1's comm step) bitwise."""
    dp, one = runs["faults"]
    n, c, s, _ = RUNS["faults"]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=c, s=s, p=0.34)
    scale = tcfg.eta_(n) / tcfg.gamma
    (x, h), (x1, h1) = dp["first"], one["first"]
    assert np.array_equal(np.isnan(x), np.isnan(x1))
    assert np.array_equal(np.isnan(h), np.isnan(h1))
    for name, o, D in zip(one["spec"].names, one["spec"].offsets,
                          one["spec"].dims):
        p, q = x[:, o:o + D], x1[:, o:o + D]
        ok = ~np.isnan(q)
        bound = 2 * _ulp(float(np.abs(q[ok]).max()))
        assert float(np.abs(p[ok] - q[ok]).max()) <= bound, name
        p, q = h[:, o:o + D], h1[:, o:o + D]
        hbound = scale * bound + 2 * _ulp(float(np.abs(q).max()))
        assert float(np.abs(p - q).max()) <= hbound, name
    assert dp["rows"][:2] == one["rows"][:2]


def test_faulted_two_ranks_decide_as_one_process(runs):
    """The 3 rounds of the survivor round: every decision (arrivals, guard
    verdicts, retries, backoff, counters) equal to one process's, losses
    within 1e-6 relative, and sum_i h_i = 0 kept (1e-4 of max|h|)."""
    dp, one = runs["faults"]
    keys = ("round", "L", "local_steps", "up_floats", "down_floats",
            "up_bytes", "down_bytes", "arrivals", "corrupted", "retries",
            "backoff_s", "quorum_miss", "round_latency_s")
    assert [{k: r[k] for k in keys} for r in dp["rows"]] == \
        [{k: r[k] for k in keys} for r in one["rows"]]
    assert sum(r["corrupted"] for r in dp["rows"]) > 0  # the guard acted
    for r, r1 in zip(dp["rows"], one["rows"]):
        assert abs(r["loss"] - r1["loss"]) <= 1e-6 * abs(r1["loss"])
    h = np.nan_to_num(dp["h"])
    assert np.abs(h.sum(0)).max() <= 1e-4 * np.abs(h).max()


def _cli(*args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--rounds", "2", "--seq-len", "16",
         "--per-client-batch", "1", *args], capture_output=True, text=True,
        timeout=timeout, env=env, cwd=REPO)


def _logged(path):
    with open(path) as f:
        return [{k: v for k, v in row.items()
                 if k not in ("wall_s", "seconds")}
                for row in csv.DictReader(f)]


def test_cli_data_parallel_matches_one_process(tmp_path):
    logs = {}
    for dp in (2, 1):
        log = str(tmp_path / f"dp{dp}.csv")
        proc = _cli("--data-parallel", str(dp), "--log", log)
        assert proc.returncode == 0, proc.stderr[-3000:]
        final = [ln for ln in proc.stdout.splitlines() if "final loss" in ln]
        assert len(final) == 1, proc.stdout
        logs[dp] = (_logged(log), final[0].rsplit("final loss", 1)[1])
    assert logs[2] == logs[1] and len(logs[2][0]) == 2


@pytest.mark.parametrize("args,needle", [
    (["--model-parallel", "2", "--arch", "qwen2-moe-a2.7b"], "A9c"),
    (["--data-parallel", "2", "--dist-backend", "nccl"], "nccl"),
    (["--data-parallel", "2", "--adversary", "sign_flip", "--f-byz",
      "0.25", "--reputation"], "A9d"),
    (["--data-parallel", "2", "--checkpoint-dir", "ckpt"], "A9d"),
    (["--data-parallel", "2", "--comm-impl", "ws"], "A9d"),
    (["--data-parallel", "2", "--pipeline"], "A9d"),
    (["--data-parallel", "2", "--adversary", "inlier", "--f-byz", "0.25"],
     "A9d"),
])
def test_cli_refuses_what_is_not_ported(args, needle, capsys):
    from repro_torch.launch import train

    with pytest.raises(SystemExit) as e:
        train.main(["--reduced", "--device", "cpu", *args])
    assert e.value.code != 0
    assert needle in capsys.readouterr().err


def test_nccl_takes_one_card_per_rank():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="gloo"):
        sharding.check_backend("nccl", "cuda", cards + 1)
    with pytest.raises(ValueError, match="gloo"):
        sharding.check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="unknown backend"):
        sharding.check_backend("mpi", "cpu", 1)
    sharding.check_backend("gloo", "cpu", 8)


def test_rank_rows_follow_the_reference_convention():
    """rows = ceil(n / world), row0 = rank rows; a rank past the end holds
    none (the reference's idle pad rows)."""
    got = [(g.row0, g.stop) for g in
           (sharding.RankRows(9, 4, r) for r in range(4))]
    assert got == [(0, 3), (3, 6), (6, 9), (9, 9)]
    got = [(g.row0, g.local) for g in
           (sharding.RankRows(2, 4, r) for r in range(4))]
    assert got == [(0, 1), (1, 1), (2, 0), (3, 0)]


def test_not_ported_over_ranks_raises():
    """With a group: the plain comm impls, the reputation, checkpoints and
    the pipelined driver raise naming A9d (a one-rank group, no process
    group needed to reach the checks)."""
    n = 4
    cfg = registry.get_reduced_config("gemma2-2b")
    g = sharding.RankRows(n, 1, 0)
    for impl in ("ws", "dense"):
        tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34,
                                          comm_impl=impl)
        with pytest.raises(ValueError, match="A9d"):
            tamuna_dp.make_comm_step(cfg, tcfg, n, device="cpu", group=g)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34)
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu",
                                 rows=g)
    pipe = SyntheticTokenPipeline(DataConfig(seq_len=8, per_client_batch=1,
                                             vocab=64, n_clients=n), cfg,
                                  "cpu")
    common = dict(cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=1,
                  rng=np.random.default_rng(0),
                  generator=torch.Generator().manual_seed(1), group=g)
    with pytest.raises(ValueError, match="A9d"):
        rounds.run_rounds(state, reputation=True,
                          plan=cohort.CohortPlan(0, n, 3),
                          faults=faults.FaultPlan(seed=0, n=n,
                                                  adversary="sign_flip",
                                                  f_byz=0.25), **common)
    with pytest.raises(ValueError, match="A9d"):
        rounds.run_rounds(state, checkpoint_dir="ckpt", checkpoint_every=1,
                          **common)
    engine = rounds.make_pipelined_round_fn(cfg, tcfg, n, pipe=pipe,
                                            device="cpu", group=g)
    with pytest.raises(ValueError, match="A9d"):
        rounds.run_rounds_pipelined(state, round_fn=engine, rounds=1,
                                    rng=np.random.default_rng(0),
                                    generator=torch.Generator(), p=0.34)


def _fail_on_rank_one(rank, dev):
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")


def test_a_failing_rank_fails_the_spawn(tmp_path):
    with pytest.raises(Exception, match="on purpose"):
        sharding.spawn(_fail_on_rank_one, 2, backend="gloo", device="cpu",
                       init_method=sharding.file_init_method(str(tmp_path)))
