"""The model-parallel round (ROADMAP A9b) on gloo ranks on the CPU:
``rounds.run_rounds(group=sharding.Mesh2D)`` of the reduced gemma2-2b at
n = 4, c = 3, s = 2 (seq 8, 2 sequences per client, max_L 2).

* **mp = 2 against one process.** One round on 2 model ranks
  (``init_state(mesh=)``, the tensor-parallel local steps, the comm step
  on the blocks) against the port's one-process round, which
  ``test_torch_round.py`` holds to the reference.  The local steps'
  row-parallel products and vocab-parallel logsumexp reassociate their
  sums, so the rounds are not bitwise; the bound comes from a float64
  evaluation of the same round (the model in float64, the workspaces in
  f32): per leaf, x and h after the round no farther from the one process
  than ``FACTOR`` times the one process's own distance from the float64
  round, plus ``FLOOR`` of the leaf's largest value.  The two model ranks
  report the same loss, within the same bound of the one process's; L
  and the counters are equal.
* **dp = 2 x mp = 2 against mp = 2.** The same round on 4 ranks: every
  rank's rows of its block, and the loss, bitwise the 2-rank run's (at s =
  2 each coordinate's two owner partials add once, as on the data axis
  alone); every data-group collective is at most the block's width, and
  the model group's collectives do not depend on the data axis.
* **Refusals.** ``run_rounds`` refuses the fault-tolerant round over model
  blocks (A9d); ``make_local_step`` refuses a family without
  tensor-parallel layers (A9c).

Both run in one ``sharding.spawn`` of 4 ranks (one intra-op thread a
rank, a ``file://`` store under the test's temporary directory), whose
first pair of model ranks first runs the mp = 2 round alone, each with a
one-rank data group.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import comm_ws, faults, rounds, sharding, tamuna_dp

N, C, S = 4, 3, 2
SEQ, MAX_L = 8, 2
# both f32 rounds are within their own rounding of the float64 one, so
# their distance is at most about twice either's; measured here the
# model-parallel round's leaves lie 0.74-1.0 times the one process's
# distance from it (the norm scales and the MLP's by one ulp in both), its
# loss 1.7 times (9.5e-7 of 6.49, two ulps).  The floor, ~3 ulps of a
# value, covers a leaf or a loss the round leaves nearly exact.
FACTOR = 2.0
FLOOR = 2.0 ** -22


def _cfg(dtype=torch.float32):
    cfg = registry.get_reduced_config("gemma2-2b")
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)


def _tcfg():
    return tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34)


def _round(cfg, mesh=None):
    """One round of ``run_rounds``: ``(x, h, rows)``, the rank's rows (of
    its blocks under ``mesh``) as numpy."""
    tcfg = _tcfg()
    state = tamuna_dp.init_state(cfg, tcfg, N, seed=0, device="cpu",
                                 mesh=mesh)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=SEQ, per_client_batch=2, vocab=512, seed=0,
                   n_clients=N), cfg, "cpu")
    state, rows = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=1,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=MAX_L,
        group=mesh)
    return state.x.numpy().copy(), state.h.numpy().copy(), rows


def _rank(rank, dev, out_dir):
    """On 4 ranks: the round on ranks 0 and 1 alone (a mesh of one data
    rank, each with its own one-rank data group), then on the whole 2 x 2
    mesh."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    whole = sharding.make_mesh(N, 2, 2)
    alone = [dist.new_group([r]) for r in range(4)]
    pair = sharding.Mesh2D(1, 2, whole.m_index,
                           sharding.RankRows(N, 1, 0, alone[rank]),
                           whole.tp)
    out = {}
    for tag, mesh in (("1x2", pair), ("2x2", whole)):
        if tag == "1x2" and whole.d_index:
            continue
        mesh.tp.sizes.clear()
        x, h, rows = _round(_cfg(), mesh)
        row = rows[0]
        out.update({f"{tag}/{k}": v for k, v in dict(
            x=x, h=h, loss=row["loss"], L=row["L"], up=row["up_floats"],
            down=row["down_floats"],
            dp_sizes=np.asarray(mesh.rows.sizes, np.int64),
            tp_sizes=np.asarray(mesh.tp.sizes, np.int64)).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{(dp, mp): [each rank's outputs of that mesh]}``; one spawn."""
    tmp = str(tmp_path_factory.mktemp("tp_round"))
    sharding.spawn(_rank, 4, backend="gloo", device="cpu",
                   init_method=sharding.file_init_method(tmp), args=(tmp,))
    got = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
           for r in range(4)]
    return {(dp, mp): [{k.split("/", 1)[1]: v for k, v in r.items()
                        if k.startswith(f"{dp}x{mp}/")}
                       for r in got[:dp * mp]]
            for dp, mp in ((1, 2), (2, 2))}


@pytest.fixture(scope="module")
def one_process():
    torch.set_num_threads(1)
    return {"f32": _round(_cfg()), "f64": _round(_cfg(torch.float64))}


def _leaves(ws, cfg, mp=1, m=0):
    mesh = None if mp == 1 else sharding.Mesh2D(1, mp, m, None, None)
    spec = tamuna_dp.state_spec(cfg, _tcfg(), mesh)
    return {k: v.numpy() for k, v in
            comm_ws.unpack(torch.from_numpy(ws), spec).items()}


def test_model_parallel_round_matches_one_process(ranks, one_process):
    cfg = _cfg()
    ps = sharding.params_pspecs(cfg, 2)
    r0, r1 = ranks[(1, 2)]
    one, wide = one_process["f32"], one_process["f64"]
    for q, i in (("x", 0), ("h", 1)):
        blocks = [_leaves(r[q], cfg, 2, m) for m, r in enumerate((r0, r1))]
        want = _leaves(one[i], cfg)
        ref64 = _leaves(wide[i], cfg)
        for name, spec in ps.items():
            got = (np.concatenate([b[name] for b in blocks],
                                  axis=1 + spec.index(True)) if any(spec)
                   else blocks[0][name])
            if not any(spec):
                assert np.array_equal(blocks[0][name], blocks[1][name])
            err = float(np.abs(got - want[name]).max())
            own = float(np.abs(want[name] - ref64[name]).max())
            top = float(np.abs(ref64[name]).max())
            assert err <= FACTOR * own + FLOOR * top, (q, name, err, own)
    l_one, l_wide = one[2][0]["loss"], wide[2][0]["loss"]
    assert float(r0["loss"]) == float(r1["loss"])
    assert abs(float(r0["loss"]) - l_one) <= FACTOR * abs(l_one - l_wide) \
        + FLOOR * abs(l_wide)
    for r in (r0, r1):
        assert int(r["L"]) == one[2][0]["L"]
        assert float(r["up"]) == one[2][0]["up_floats"]
        assert float(r["down"]) == one[2][0]["down_floats"]


def test_data_and_model_parallel_round_matches_model_parallel(ranks):
    """dp 2 x mp 2 against mp 2: bitwise at s = 2."""
    mp2, dpmp = ranks[(1, 2)], ranks[(2, 2)]
    for rank, r in enumerate(dpmp):
        d, m = divmod(rank, 2)
        rows = slice(2 * d, 2 * d + 2)
        for q in ("x", "h"):
            assert np.array_equal(r[q], mp2[m][q][rows]), (rank, q)
        assert float(r["loss"]) == float(mp2[m]["loss"])
        width = r["x"].shape[1]
        assert r["dp_sizes"].max() <= width
        # the model group's sums are the same whatever the data axis
        # (gradients of the members a data rank hosts, the scales' none)
        assert r["tp_sizes"].max() == mp2[m]["tp_sizes"].max()


def test_refusals():
    cfg = _cfg()
    mesh = sharding.Mesh2D(1, 2, 0, sharding.RankRows(N, 1, 0), None)
    with pytest.raises(ValueError, match="A9c"):
        tamuna_dp.make_local_step(registry.get_reduced_config(
            "qwen2-moe-a2.7b"), _tcfg(), mesh)
    state = tamuna_dp.init_state(cfg, _tcfg(), N, seed=0, device="cpu",
                                 mesh=mesh)
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=8, per_client_batch=1, vocab=64, n_clients=N),
        cfg, "cpu")
    with pytest.raises(ValueError, match="A9d"):
        rounds.run_rounds(state, cfg=cfg, tcfg=_tcfg(), pipe=pipe, rounds=1,
                          rng=np.random.default_rng(0),
                          generator=torch.Generator().manual_seed(1),
                          faults=faults.FaultPlan(seed=0, n=N, p_drop=0.25),
                          group=mesh)
