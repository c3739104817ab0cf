"""The rest of the dense family in the port against the reference:
gemma2-9b, stablelm-3b (q/k/v biases, untied head), deepseek-coder-33b
(untied head, GQA 8:2 at head_dim 32) and internvl2-26b (untied head and a
stub frontend's ``prefix_embeds`` through ``prefix_proj``).

Each test holds the port against the JAX package on the same numpy-seeded
inputs, with the reference's weights carried over by
``repro_torch.convert``.  The reference initialises the biases to zero,
which could not show a missing bias add, so the loss tests give them
random values on both sides first.  Tolerances: the reduced configs' loss
and every per-leaf gradient within 1e-5 relative in f32 (to the leaf's
largest entry), as ``tests/test_torch_model.py`` holds gemma2-2b; in bf16
within ``tests/test_torch_attention.py``'s 5e-5 and 5e-2; prefill logits
within 1e-5 and decode logits within 2e-5 of the largest, as
``tests/test_torch_serve.py``.

bf16 is held against the reference evaluated op by op (its layers unrolled,
un-jitted), not against its scanned forward: XLA compiles the scan body
with fused elementwise chains that skip bf16 roundings, so the reference's
own scanned loss differs from its op-by-op loss by 1e-4 to 8e-4 relative
at these sizes (measured on the CPU), while the port, which rounds after
every operation as the reference's code is written, agrees with the
op-by-op loss within 5e-5 (measured 2.8e-6 for stablelm-3b at t = 72).
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import registry as jregistry
from repro.dist import model_api as japi
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist import model_api
from repro_torch.models import transformer as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = ["gemma2-9b", "stablelm-3b", "deepseek-coder-33b", "internvl2-26b"]
# past gemma2-9b's reduced window of 64
T, B = 72, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(arch, dtype=None, seed=0):
    """The reduced config in both frameworks (``dtype`` the compute dtype
    when given) and the reference's init with random q/k/v biases:
    ``(jcfg, cfg, jparams, {name: array})``."""
    jcfg, cfg = jregistry.get_reduced_config(arch), \
        registry.get_reduced_config(arch)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(
            cfg, dtype=torch.float32 if dtype == jnp.float32
            else torch.bfloat16)
    names, leaves, treedef = checkpoint._flatten_with_names(
        japi.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    arrays = {}
    for n, a in zip(names, leaves):
        a = np.asarray(a)
        if n.startswith("blocks/attn/b"):
            assert not a.any()  # the reference's zeros
            a = (0.5 * rng.normal(size=a.shape)).astype(np.float32)
        arrays[n] = a
    jparams = jax.tree.unflatten(treedef,
                                 [jnp.asarray(arrays[n]) for n in names])
    return jcfg, cfg, jparams, arrays


def _batch(cfg, t=T, seed=0):
    """tokens, labels ``(B, t)`` int32 and, for a prefix model, the
    prefix embeddings ``(B, P, d_model)`` f32 (``None`` otherwise)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, t + 1)).astype(np.int32)
    pe = (rng.normal(size=(B, cfg.prefix_len, cfg.d_model))
          .astype(np.float32) if cfg.prefix_len else None)
    return toks[:, :-1], toks[:, 1:], pe


def _tt(a):
    return None if a is None else torch.from_numpy(a)


def _op_by_op_loss(params, jcfg, tokens, labels, prefix_embeds=None):
    """The reference's ``loss_fn`` with its layer scan unrolled, for an
    un-jitted (op-by-op) evaluation: the same operations in the same
    order, each rounded to the compute dtype."""
    from repro.models import layers as jlayers
    from repro.models import transformer as jtr

    x = params["embed"].astype(jcfg.dtype)[tokens]
    if jcfg.scale_embed:
        x = x * jnp.asarray(jnp.sqrt(jcfg.d_model).astype(jnp.float32),
                            jcfg.dtype)
    if prefix_embeds is not None:
        pe = prefix_embeds.astype(jcfg.dtype)
        if "prefix_proj" in params:
            pe = jlayers.matmul(pe, params["prefix_proj"])
        x = jnp.concatenate([pe, x], axis=1)
    windows = jcfg.layer_windows()
    for l in range(jcfg.n_layers):
        bp = jax.tree.map(lambda a: a[l], params["blocks"])
        x, _ = jtr._attn_ff_block(bp, x, jcfg, windows[l])
    h = jlayers.rmsnorm(params["final_norm"], x)
    if prefix_embeds is not None:
        h = h[:, prefix_embeds.shape[1]:]
    return jlayers.chunked_softmax_xent(
        h, jtr.lm_head_weight(params, jcfg), labels, chunk=jcfg.xent_chunk,
        logit_softcap=jcfg.final_softcap, valid_vocab=jcfg.vocab)


@pytest.mark.parametrize("arch", NEW)
def test_config_fields_match_reference(arch):
    """Both the published and the reduced config, field by field, with the
    windows and the padded vocab."""
    for jcfg, cfg in ((jregistry.get_config(arch), registry.get_config(arch)),
                      (jregistry.get_reduced_config(arch),
                       registry.get_reduced_config(arch))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim", "rope_theta",
                  "qkv_bias", "attn_softcap", "final_softcap",
                  "sliding_window", "local_global_pattern",
                  "sliding_window_override", "post_norm", "act",
                  "tie_embeddings", "prefix_len", "scale_embed",
                  "xent_chunk", "source"):
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
        assert cfg.head_dim_ == jcfg.head_dim_
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.layer_windows() == list(np.asarray(jcfg.layer_windows()))
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
    assert arch in registry.list_archs()


@pytest.mark.parametrize("arch,dtype,loss_tol,grad_tol", [
    ("gemma2-9b", jnp.float32, 1e-5, 1e-5),
    ("stablelm-3b", jnp.float32, 1e-5, 1e-5),
    ("deepseek-coder-33b", jnp.float32, 1e-5, 1e-5),
    ("internvl2-26b", jnp.float32, 1e-5, 1e-5),
    ("stablelm-3b", jnp.bfloat16, 5e-5, 5e-2)])
def test_loss_and_grads_match_reference(arch, dtype, loss_tol, grad_tol):
    """The loss and every per-leaf gradient under ``jax.grad`` of
    ``model_api.loss`` (f32, jitted) or of the op-by-op evaluation (bf16),
    with random biases and (internvl2-26b) the same prefix embeddings on
    both sides."""
    jcfg, cfg, jparams, arrays = _weights(arch, dtype)
    tokens, labels, pe = _batch(cfg)
    jpe = None if pe is None else jnp.asarray(pe)
    jt, jlab = jnp.asarray(tokens), jnp.asarray(labels)
    if dtype == jnp.float32:
        jl, jg = jax.jit(jax.value_and_grad(lambda p: japi.loss(
            p, jcfg, tokens=jt, labels=jlab, prefix_embeds=jpe)[0]))(jparams)
    else:
        jl, jg = jax.value_and_grad(lambda p: _op_by_op_loss(
            p, jcfg, jt, jlab, jpe))(jparams)
    names, jleaves, _ = checkpoint._flatten_with_names(jg)
    params = {k: v.requires_grad_(True) for k, v in
              convert.params_from_numpy(arrays, cfg, "cpu").items()}
    loss, _ = model_api.loss(params, cfg,
                             tokens=torch.from_numpy(tokens).long(),
                             labels=torch.from_numpy(labels).long(),
                             prefix_embeds=_tt(pe))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(jl)) <= loss_tol * abs(float(jl))
    assert list(params) == names
    for name, g, want in zip(names, grads, jleaves):
        want = np.asarray(want, np.float32)
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= grad_tol, (name, err)


def test_bias_and_prefix_reach_the_loss():
    """The loss tests' inputs can see what they hold: dropping stablelm's
    biases or internvl2's prefix changes the loss by far more than the
    tolerance, and internvl2's loss covers the text positions only."""
    _, cfg, _, arrays = _weights("stablelm-3b")
    tokens, labels, _ = _batch(cfg)
    tok, lab = torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()
    with torch.no_grad():
        params = convert.params_from_numpy(arrays, cfg, "cpu")
        l1 = model_api.loss(params, cfg, tokens=tok, labels=lab)[0]
        for n in ("blocks/attn/bq", "blocks/attn/bk", "blocks/attn/bv"):
            params[n].zero_()
        l0 = model_api.loss(params, cfg, tokens=tok, labels=lab)[0]
        assert abs(l1 - l0) > 1e-3 * abs(l0)

        _, cfg, _, arrays = _weights("internvl2-26b")
        tokens, labels, pe = _batch(cfg)
        tok, lab = (torch.from_numpy(a).long() for a in (tokens, labels))
        params = convert.params_from_numpy(arrays, cfg, "cpu")
        lp = model_api.loss(params, cfg, tokens=tok, labels=lab,
                            prefix_embeds=torch.from_numpy(pe))[0]
        ln = model_api.loss(params, cfg, tokens=tok, labels=lab)[0]
        assert abs(lp - ln) > 1e-3 * abs(ln)
        h = tr.forward(params, cfg, tok, torch.from_numpy(pe))
        assert h.shape == (B, cfg.prefix_len + T, cfg.d_model)


@pytest.mark.parametrize("arch", ["stablelm-3b", "internvl2-26b"])
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` (internvl2-26b with its prefix) within 1e-5 of the
    largest logit, and 12 decode steps on an f32 cache within 2e-5, the
    cache within 1e-5 of its largest entry."""
    jcfg, cfg, jparams, arrays = _weights(arch)
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    tokens, _, pe = _batch(cfg, t=24, seed=3)
    want = np.asarray(japi.prefill(
        jparams, jcfg, tokens=jnp.asarray(tokens),
        prefix_embeds=None if pe is None else jnp.asarray(pe)))
    with torch.no_grad():
        got = model_api.prefill(params, cfg,
                                tokens=torch.from_numpy(tokens).long(),
                                prefix_embeds=_tt(pe)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    steps = 12
    jstep = jax.jit(lambda p, t, c, pos: japi.decode(p, jcfg, t, c, pos))
    jcache = japi.make_cache(jcfg, B, steps, kv_dtype=jnp.float32)
    cache = model_api.make_cache(cfg, B, steps, kv_dtype=torch.float32,
                                 device="cpu")
    for i in range(steps):
        wl, jcache = jstep(jparams, jnp.asarray(tokens[:, i:i + 1]), jcache,
                           jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            gl, cache = model_api.decode(
                params, cfg, torch.from_numpy(tokens[:, i:i + 1]).long(),
                cache, i)
        wl = np.asarray(wl)
        assert np.abs(gl.numpy() - wl).max() <= 2e-5 * np.abs(wl).max(), i
    for name in ("k", "v"):
        a, b = cache[name].numpy(), np.asarray(jcache[name])
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name


@pytest.mark.parametrize("arch", ["stablelm-3b", "internvl2-26b"])
def test_checkpoint_carries_the_new_leaves(arch, tmp_path):
    """A reference ``checkpoint.save`` of the reduced model, with
    ``lm_head``, the biases and ``prefix_proj``, read by
    ``convert.read_checkpoint`` and ``params_from_numpy``: bitwise leaves
    and the reference's loss; a missing or an extra leaf is refused."""
    jcfg, cfg, jparams, arrays = _weights(arch, seed=5)
    checkpoint.save(str(tmp_path / "ckpt"), jparams, step=1)
    got = convert.read_checkpoint(str(tmp_path / "ckpt"))
    assert "lm_head" in got
    assert ("prefix_proj" in got) == bool(cfg.prefix_len)
    assert ("blocks/attn/bq" in got) == cfg.qkv_bias
    params = convert.params_from_numpy(got, cfg, "cpu")
    for name, a in arrays.items():
        np.testing.assert_array_equal(params[name].numpy(), a)
    tokens, labels, pe = _batch(cfg, t=16, seed=4)
    want = float(japi.loss(jparams, jcfg, tokens=jnp.asarray(tokens),
                           labels=jnp.asarray(labels),
                           prefix_embeds=None if pe is None
                           else jnp.asarray(pe))[0])
    with torch.no_grad():
        loss = model_api.loss(params, cfg,
                              tokens=torch.from_numpy(tokens).long(),
                              labels=torch.from_numpy(labels).long(),
                              prefix_embeds=_tt(pe))[0].item()
    assert abs(loss - want) <= 1e-5 * abs(want)
    drop = "prefix_proj" if cfg.prefix_len else "blocks/attn/bq"
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy(
            {k: v for k, v in got.items() if k != drop}, cfg, "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        convert.params_from_numpy({**got, "extra": got["lm_head"]}, cfg,
                                  "cpu")
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_numpy({**got, "lm_head": got["lm_head"].T}, cfg,
                                  "cpu")


def test_pipeline_draws_prefix_embeds():
    """internvl2-26b's batches carry ``(c, b, P, d_model)`` prefix
    embeddings in its compute dtype, drawn after the tokens (which stay
    the ones a prefix-free model gets); gemma2-2b's carry none."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline

    dcfg = DataConfig(seq_len=8, per_client_batch=2, vocab=64, n_clients=3)
    cfg = registry.get_reduced_config("internvl2-26b")
    batch = SyntheticTokenPipeline(dcfg, cfg, "cpu").sample_batch([0, 2])
    pe = batch["prefix_embeds"]
    assert pe.shape == (2, 2, cfg.prefix_len, cfg.d_model)
    assert pe.dtype == cfg.dtype and bool(torch.isfinite(pe).all())
    assert 0.9 < float(pe.std()) < 1.1
    plain = SyntheticTokenPipeline(
        dcfg, registry.get_reduced_config("gemma2-2b"), "cpu"
    ).sample_batch([0, 2])
    assert "prefix_embeds" not in plain
    assert torch.equal(plain["tokens"], batch["tokens"])


def _run(args, timeout=300):
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread, as in-process
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


def test_train_cli_trains_the_prefix_model_on_cpu():
    proc = _run(["-m", "repro_torch.launch.train", "--arch",
                 "internvl2-26b", "--reduced", "--rounds", "2",
                 "--seq-len", "32", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"on cpu in [0-9.]+s; final loss (\S+)$",
                  proc.stdout.strip())
    assert m and math.isfinite(float(m.group(1))), proc.stdout


def test_serve_cli_serves_stablelm_on_cpu():
    proc = _run(["-m", "repro_torch.launch.serve", "--arch", "stablelm-3b",
                 "--reduced", "--batch", "2", "--prompt-len", "8",
                 "--gen-len", "4", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"sample continuations: (\[\[.*\]\])", proc.stdout)
    assert m, proc.stdout
    toks = json.loads(m.group(1))
    assert len(toks) == 2 and all(len(t) == 4 for t in toks)
    vocab = registry.get_reduced_config("stablelm-3b").vocab
    assert all(0 <= x < vocab for t in toks for x in t)


def test_f32_gradients_sit_as_far_from_float64_on_both_sides():
    """The port's f32 gradients of reduced stablelm-3b (its untied
    embedding's reach 4.0) are no farther from the port's float64
    evaluation than the reference's f32 gradients are, leaf by leaf, up
    to 2x and 1e-6 of the leaf's largest entry: what the two frameworks
    disagree by is f32 rounding, which the reduced round carries into h
    (``tests/test_torch_round.py``'s ``H_TOL``)."""
    jcfg, cfg, jparams, arrays = _weights("stablelm-3b")
    tokens, labels, _ = _batch(cfg, t=32, seed=6)
    jg = jax.jit(jax.grad(lambda p: japi.loss(
        p, jcfg, tokens=jnp.asarray(tokens),
        labels=jnp.asarray(labels))[0]))(jparams)
    names, jleaves, _ = checkpoint._flatten_with_names(jg)
    got = {}
    for dt in (torch.float32, torch.float64):
        c = dataclasses.replace(cfg, dtype=dt)
        p = {n: torch.from_numpy(arrays[n]).to(dt).requires_grad_(True)
             for n in names}
        loss, _ = model_api.loss(p, c, tokens=torch.from_numpy(tokens).long(),
                                 labels=torch.from_numpy(labels).long())
        got[dt] = torch.autograd.grad(loss, list(p.values()))
    for name, w, g32, g64 in zip(names, jleaves, got[torch.float32],
                                 got[torch.float64]):
        g64 = g64.numpy()
        top = np.abs(g64).max()
        ref_err = np.abs(np.asarray(w, np.float64) - g64).max() / top
        port_err = np.abs(g32.double().numpy() - g64).max() / top
        assert port_err <= 2 * ref_err + 1e-6, (name, port_err, ref_err)
