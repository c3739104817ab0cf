"""``run_rounds(flush_every=)``: the metric drain of the synchronous
driver (the reference's ``rounds.run_rounds(flush_every=10)``), and
``--flush-every`` through the CLI and the examples.

Each round's loss sum stays on the device and a window of rows is built
at its drain, so the rows (all keys but ``seconds``, in order), the state
and the checkpoints must not depend on ``flush_every``: held bitwise over
7 rounds at ``flush_every`` 1, 3 and 10 (clamped to 7) for the fault-free
round and the faulted (drops, quorum, quarantine), guarded (NaN payloads)
and reputation rounds.  CPU only; reduced gemma2-2b at 16 tokens.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_state
from repro_torch.configs import gemma2_2b
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import cohort, faults, rounds, tamuna_dp

N, C, S, ROUNDS = 5, 4, 3, 7

SCENARIOS = {
    "fault_free": dict(tcfg={}, kw=lambda: {}),
    "faulted": dict(tcfg={}, kw=lambda: dict(
        plan=cohort.CohortPlan(0, N, C),
        faults=faults.FaultPlan(seed=0, n=N, p_drop=0.3),
        policy="quorum", quarantine_rounds=2)),
    "guarded": dict(tcfg={}, kw=lambda: dict(
        plan=cohort.CohortPlan(0, N, C),
        faults=faults.FaultPlan(seed=1, n=N, p_drop=0.2, p_corrupt=0.3,
                                corrupt_mode="nan"),
        policy="quorum", quarantine_rounds=1)),
    "reputation": dict(
        tcfg=dict(robust_agg="trimmed", trim_k=1), kw=lambda: dict(
            plan=cohort.CohortPlan(0, N, C),
            faults=faults.FaultPlan(seed=0, n=N, adversary="sign_flip",
                                    f_byz=0.2),
            policy="quorum", reputation=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ListLogger:
    def __init__(self):
        self.seen = []

    def log(self, step, row):
        self.seen.append((step, dict(row)))


def _run(scenario, flush_every, **extra):
    cfg = gemma2_2b.REDUCED
    sc = SCENARIOS[scenario]
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.5,
                                      **sc["tcfg"])
    state = tamuna_dp.init_state(cfg, tcfg, N, seed=0, device="cpu")
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=16, per_client_batch=1, vocab=64, seed=0,
                   n_clients=N), cfg, "cpu")
    logger = ListLogger()
    state, rows = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=ROUNDS,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=3,
        logger=logger, flush_every=flush_every, **sc["kw"](), **extra)
    return state, rows, logger.seen


def _without_seconds(rows):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in rows]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_rows_do_not_depend_on_flush_every(scenario):
    """flush_every 1, 3 and 10 give the same rows but for ``seconds`` (keys
    in the same order), the same state bitwise, and the logger sees every
    row once, in round order, as returned."""
    runs = {f: _run(scenario, f) for f in (1, 3, 10)}
    s1, rows1, seen1 = runs[1]
    assert len(rows1) == ROUNDS and all(np.isfinite(r["loss"])
                                        for r in rows1)
    for f, (st, rows, seen) in runs.items():
        assert [list(r) for r in rows] == [list(r) for r in rows1]
        assert _without_seconds(rows) == _without_seconds(rows1), f
        assert st.x.numpy().tobytes() == s1.x.numpy().tobytes()
        assert st.h.numpy().tobytes() == s1.h.numpy().tobytes()
        assert [step for step, _ in seen] == list(range(ROUNDS))
        assert [row for _, row in seen] == rows
        assert all(r["seconds"] > 0 for r in rows)
    if scenario != "fault_free":
        assert "arrivals" in rows1[0]
    if scenario == "reputation":
        assert "anomaly_max" in rows1[0]


def test_flush_every_is_clamped_and_windows_add_up():
    """``flush_every`` 0 and -3 drain every round, as 1 does (the
    reference's clamp to ``[1, rounds]``)."""
    _, rows1, _ = _run("fault_free", 1)
    for f in (0, -3):
        _, rows, _ = _run("fault_free", f)
        assert _without_seconds(rows) == _without_seconds(rows1)


def test_checkpoints_do_not_depend_on_flush_every(tmp_path):
    """``checkpoint_every=2`` saves the same states at ``flush_every`` 1
    and 3 (the saves fall inside the windows at 3)."""
    saved = {}
    for f in (1, 3):
        root = tmp_path / f"f{f}"
        st, _, _ = _run("fault_free", f, checkpoint_dir=str(root),
                        checkpoint_every=2)
        saved[f] = sorted(p.name for p in root.iterdir())
        assert saved[f] == ["step_2", "step_4", "step_6"]
        for name in saved[f]:
            back = restore_state(str(root / name), st)
            saved[(f, name)] = (back.x.numpy().tobytes(),
                                back.h.numpy().tobytes())
    for name in saved[1]:
        assert saved[(1, name)] == saved[(3, name)]


class _Called(Exception):
    pass


def _capture(monkeypatch, module, name):
    """Replace ``module.name`` by a recorder that stops the caller."""
    got = {}

    def fake(*args, **kw):
        got.update(kw)
        raise _Called

    monkeypatch.setattr(module, name, fake)
    return got


@pytest.mark.parametrize("pipeline", [False, True])
def test_cli_flush_every_reaches_both_drivers(monkeypatch, pipeline):
    from repro_torch.launch import train

    name = "run_rounds_pipelined" if pipeline else "run_rounds"
    argv = ["--reduced", "--rounds", "4", "--seq-len", "16", "--device",
            "cpu", "--clients", "8", "--cohort", "2"]
    got = _capture(monkeypatch, rounds, name)
    with pytest.raises(_Called):
        train.main(argv + (["--pipeline"] if pipeline else []))
    assert got["flush_every"] == 10  # the default
    got = _capture(monkeypatch, rounds, name)
    with pytest.raises(_Called):
        train.main(argv + ["--flush-every", "3"]
                   + (["--pipeline"] if pipeline else []))
    assert got["flush_every"] == 3


@pytest.mark.parametrize("example, argv, want", [
    ("train_lm", ["--rounds", "4", "--seq-len", "16"], 5),
    ("federated_sim", ["--lm", "--rounds", "4"], 4),
    ("availability_sim", ["--dist", "--rounds", "4"], 4),
    ("availability_sim", ["--dist", "--faults", "--rounds", "12"], 10),
])
def test_examples_pass_the_references_flush_every(monkeypatch, example, argv,
                                                  want):
    """The port's examples pass ``flush_every`` as the reference's scripts
    do: 5 (``train_lm``), the run's rounds (``federated_sim --lm``),
    ``min(10, rounds)`` (``availability_sim --dist``)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{example}")
    got = _capture(monkeypatch, rounds, "run_rounds")
    with pytest.raises(_Called):
        mod.main(argv + ["--device", "cpu"])
    assert got["flush_every"] == want
