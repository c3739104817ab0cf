"""The port's checkpoints (``repro_torch.checkpoint``) in the reference's
format.

* a round trip of a tree with f32, int32 and bf16 leaves (bf16 stored as
  its uint16 bits, restored bit for bit) and ``latest_step``;
* the atomic save: a crash mid-save leaves neither the checkpoint nor its
  staging directory, a save over an existing checkpoint replaces it, and a
  leaf-count mismatch names the leaf paths on both sides (mirrors of
  ``tests/test_faults.py`` and ``tests/test_substrate.py``);
* interop with the reference, through the ``subproc`` fixture (a process of
  its own for jax): a port checkpoint of an AdamW ``DistTamunaState`` is
  restored by the reference's ``checkpoint.restore`` into the reference's
  own state and saved again, and the port restores that bit for bit; a
  reference state with bf16 parameters restores into the port's f32
  workspace widened exactly;
* a resume on the CPU: 2 rounds, ``save_state``, ``restore_state`` into a
  fresh state, 2 more rounds, against 4 rounds in one go, bitwise (the host
  streams are carried across, as the reference does not save them);
* ``launch.train --uplink block_rs --comm-impl ws --checkpoint-dir ...
  --checkpoint-every 1`` on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import comm_ws, rounds, tamuna_dp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_roundtrip_with_bf16_bits(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(2, 3, generator=g),
            "nested": {"b": torch.randn(4, generator=g).to(torch.bfloat16),
                       "n": np.int32(7)},
            "s": np.float32(2.5)}
    path = os.path.join(tmp_path, "step_3")
    checkpoint.save(path, tree, step=3)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["names"] == ["a", "nested/b", "nested/n", "s"]
    assert meta["dtypes"] == ["float32", "bfloat16", "int32", "float32"]
    assert meta["step"] == 3 and meta["shapes"] == [[2, 3], [4], [], []]
    like = {"a": torch.zeros(2, 3),
            "nested": {"b": torch.zeros(4, dtype=torch.bfloat16),
                       "n": np.int32(0)}, "s": np.float32(0)}
    got = checkpoint.restore(path, like)
    assert torch.equal(got["a"], tree["a"])
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["b"].view(torch.int16),
                       tree["nested"]["b"].view(torch.int16))
    assert got["nested"]["n"] == 7 and got["s"] == np.float32(2.5)
    # bf16 bits into an f32 leaf widen exactly
    like["nested"]["b"] = torch.zeros(4)
    wide = checkpoint.restore(path, like)["nested"]["b"]
    assert torch.equal(wide, tree["nested"]["b"].to(torch.float32))
    assert checkpoint.latest_step(str(tmp_path)) == 3


def test_atomic_crash_leaves_nothing(tmp_path, monkeypatch):
    tree = {"w": torch.arange(6.0), "b": torch.ones(2, 3)}
    root = tmp_path / "ckpt"
    path = str(root / "step_4")
    real_dump = json.dump

    def boom(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(json, "dump", boom)
    with pytest.raises(OSError):
        checkpoint.save(path, tree, 4)
    monkeypatch.setattr(json, "dump", real_dump)
    assert not os.path.exists(path)
    assert checkpoint.latest_step(str(root)) is None
    assert (os.listdir(root) if root.is_dir() else []) == []
    checkpoint.save(path, tree, 4)
    got = checkpoint.restore(path, {k: torch.zeros_like(v)
                                    for k, v in tree.items()})
    for k in tree:
        assert torch.equal(got[k], tree[k])
    assert checkpoint.latest_step(str(root)) == 4


def test_save_replaces_existing(tmp_path):
    path = str(tmp_path / "step_1")
    checkpoint.save(path, {"w": torch.zeros(3)}, 1)
    checkpoint.save(path, {"w": torch.ones(3)}, 1)
    got = checkpoint.restore(path, {"w": torch.zeros(3)})
    assert torch.equal(got["w"], torch.ones(3))
    assert sorted(os.listdir(tmp_path)) == ["step_1"]


def test_leaf_mismatch_names_paths(tmp_path):
    path = str(tmp_path / "step_2")
    checkpoint.save(path, {"w": torch.zeros(3), "extra": torch.zeros(2)}, 2)
    with pytest.raises(ValueError) as ei:
        checkpoint.restore(path, {"w": torch.zeros(3),
                                  "other": torch.zeros(1), "z": torch.zeros(1)})
    msg = str(ei.value)
    assert "in checkpoint but not in target: ['extra']" in msg
    assert "in target but not in checkpoint: ['other', 'z']" in msg
    with pytest.raises(ValueError, match="shape mismatch at leaf 'w'"):
        checkpoint.restore(path, {"w": torch.zeros(4),
                                  "extra": torch.zeros(2)})


def _adam_state(seed):
    cfg = registry.get_reduced_config("gemma2-2b")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34,
                                      local_opt="adamw")
    state = tamuna_dp.init_state(cfg, tcfg, 4, seed=0, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for ws in (state.x, state.h, state.opt.mu, state.opt.nu):
        ws.copy_(torch.randn(ws.shape, generator=g))
    state.opt = state.opt._replace(count=3)
    state.round = 5
    state.up_floats, state.down_floats = np.float32(1.5), np.float32(2.5)
    state.up_bytes, state.down_bytes = np.float32(6.0), np.float32(10.0)
    return cfg, tcfg, state


REFERENCE_SIDE = """
import jax, jax.numpy as jnp, numpy as np
from repro import checkpoint
from repro.configs import registry
from repro.dist import tamuna_dp as jtd
cfg = registry.get_reduced_config("gemma2-2b")
tcfg = jtd.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34, local_opt="adamw")
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
like = jtd.init_state(jax.random.key(0), cfg, mesh, tcfg, n=4)
got = checkpoint.restore({port!r}, like)
assert int(got.round) == 5 and int(got.opt.count) == 3
assert float(got.up_bytes) == 6.0
checkpoint.save({back!r}, got, 5)
# a state with bf16 parameters and its exact f32 values
rng = np.random.default_rng(1)
x = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                       jnp.bfloat16), like.x)
st = like._replace(x=x, round=jnp.int32(9))
checkpoint.save({bf16!r}, st, 9)
names, leaves, _ = checkpoint._flatten_with_names(st)
np.savez({want!r}, **{{n: np.asarray(a).astype(np.float32)
                       for n, a in zip(names, leaves)}})
print("ok")
"""


def test_checkpoint_interop_with_reference(tmp_path, subproc):
    cfg, tcfg, state = _adam_state(2)
    paths = {k: str(tmp_path / k) for k in ("port", "back", "bf16")}
    paths["want"] = str(tmp_path / "want.npz")
    checkpoint.save_state(paths["port"], state, 5)
    out = subproc(REFERENCE_SIDE.format(**paths), devices=1, timeout=600)
    assert out.strip().endswith("ok")
    # the reference's save of what it restored comes back bit for bit
    _, _, fresh = _adam_state(3)
    checkpoint.restore_state(paths["back"], fresh)
    for a, b in ((fresh.x, state.x), (fresh.h, state.h),
                 (fresh.opt.mu, state.opt.mu), (fresh.opt.nu, state.opt.nu)):
        assert torch.equal(a, b)
    assert fresh.opt.count == 3 and fresh.round == 5
    assert fresh.up_bytes == np.float32(6.0)
    # bf16 parameters widen exactly into the f32 workspace
    checkpoint.restore_state(paths["bf16"], fresh)
    want = np.load(paths["want"])
    xs = comm_ws.unpack(fresh.x, fresh.spec)
    for name, v in xs.items():
        assert v.numpy().tobytes() == want[f".x/{name}"].tobytes(), name
    assert fresh.round == 9


def _run(state, cfg, tcfg, pipe, rng, gen, n_rounds, **kw):
    return rounds.run_rounds(state, cfg=cfg, tcfg=tcfg, pipe=pipe,
                             rounds=n_rounds, rng=rng, generator=gen,
                             max_L=2, **kw)


def test_resume_two_plus_two_equals_four_bitwise(tmp_path):
    cfg = registry.get_reduced_config("gemma2-2b")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34,
                                      local_opt="adamw", uplink="block_rs")

    def pipe():
        return SyntheticTokenPipeline(
            DataConfig(seq_len=16, per_client_batch=2, vocab=512, seed=0,
                       n_clients=4), cfg, "cpu")

    whole = tamuna_dp.init_state(cfg, tcfg, 4, seed=0, device="cpu")
    whole, rows_w = _run(whole, cfg, tcfg, pipe(), np.random.default_rng(0),
                         torch.Generator().manual_seed(1), 4)
    part = tamuna_dp.init_state(cfg, tcfg, 4, seed=0, device="cpu")
    rng, gen, p = np.random.default_rng(0), torch.Generator().manual_seed(1), \
        pipe()
    part, rows_a = _run(part, cfg, tcfg, p, rng, gen, 2,
                        checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert checkpoint.latest_step(str(tmp_path)) == 2
    resumed = tamuna_dp.init_state(cfg, tcfg, 4, seed=5, device="cpu")
    checkpoint.restore_state(str(tmp_path / "step_2"), resumed)
    assert resumed.round == 2 and resumed.opt.count == part.opt.count
    resumed, rows_b = _run(resumed, cfg, tcfg, p, rng, gen, 2)
    for a, b in ((resumed.x, whole.x), (resumed.h, whole.h),
                 (resumed.opt.mu, whole.opt.mu),
                 (resumed.opt.nu, whole.opt.nu)):
        assert torch.equal(a, b)
    assert resumed.opt.count == whole.opt.count
    for k in ("round", "up_floats", "down_floats", "up_bytes", "down_bytes"):
        assert getattr(resumed, k) == getattr(whole, k), k
    assert [r["loss"] for r in rows_a + rows_b] == [r["loss"] for r in rows_w]


def test_train_cli_block_rs_ws_with_checkpoints(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    ck = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--rounds", "2", "--seq-len", "16",
         "--uplink", "block_rs", "--comm-impl", "ws", "--checkpoint-dir",
         ck, "--checkpoint-every", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "final loss" in proc.stdout
    assert sorted(os.listdir(ck)) == ["step_1", "step_2"]
    assert checkpoint.latest_step(ck) == 2
    cfg = registry.get_reduced_config("gemma2-2b")
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.34,
                                      uplink="block_rs")
    state = tamuna_dp.init_state(cfg, tcfg, 4, seed=0, device="cpu")
    checkpoint.restore_state(os.path.join(ck, "step_2"), state)
    assert state.round == 2 and torch.isfinite(state.x).all()
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--checkpoint-every", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert bad.returncode == 2 and "--checkpoint-dir" in bad.stderr
