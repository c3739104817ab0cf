"""The encoder-decoder family (whisper-tiny) in the port against the
reference, on the CPU.

Each test holds the port against the JAX package on the same numpy-seeded
inputs, with the reference's weights carried over by
``repro_torch.convert``.  The reference initialises the attention and
layernorm biases to zero and the layernorm scales to one, which could not
show a missing or misread leaf, so the model tests randomise them on both
sides first.

Tolerances: the layers within 1e-6 of the largest entry in f32 (one bf16
ulp in bf16); the f32 loss within 1e-5 relative and every gradient within
2e-5 of the leaf's largest entry, but the key biases', which are zero in
exact arithmetic (a key bias shifts every logit of a query alike, and the
softmax does not see it): there both sides lie below 1e-7 of the largest
gradient of the model (measured ~1e-10 and ~5e-10 against 0.08).  bf16
against the reference evaluated op by op (its layer scans unrolled,
un-jitted: ``tests/test_torch_family.py``'s rule).  Decode logits within
2e-5 of the largest, as ``tests/test_torch_serve.py``.

The sinusoid: at (1500, 384) the port's table lies within 4e-6 of the
reference's eager (un-jitted) table (measured 3.8e-6, on ~5% of the
entries), while the reference's jitted table lies up to 8.6e-5 from its own
eager one (on ~27%): both round the f32 angle ``pos / 10000^(2i/d)`` at
large positions, and XLA's fused form rounds it otherwise.  All three lie
~1.07e-4 from a float64 table.  So the port is held to the eager table.
"""

import dataclasses
import functools
import json
import math
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import registry as jregistry
from repro.dist import model_api as japi
from repro.dist import tamuna_dp as jtd
from repro.models import encdec as jenc
from repro.models import layers as jl
from repro_torch import convert, serve_utils
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import comm_ws, model_api, tamuna_dp
from repro_torch.kernels import uplink
from repro_torch.launch import serve, train
from repro_torch.models import encdec, layers

ARCH = "whisper-tiny"
B, T = 2, 40
N, C, S, L = 4, 3, 2, 2
COHORT = [0, 2, 3]
DOWN = np.array([True, False, True, True])  # row 1 idle in both cohorts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(dtype=None, seed=0):
    """The reduced config in both frameworks (``dtype`` the compute dtype
    when given) and the reference's init with random biases and layernorm
    scales: ``(jcfg, cfg, jparams, {name: array})``."""
    jcfg, cfg = (jregistry.get_reduced_config(ARCH),
                 registry.get_reduced_config(ARCH))
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
        if n.endswith(("/bias", "/bk", "/bq", "/bv")):
            assert not a.any()  # the reference's zeros
            a = (0.3 * rng.normal(size=a.shape)).astype(np.float32)
        elif n.endswith("/scale"):
            assert (a == 1).all()
            a = (1 + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
        arrays[n] = a
    jparams = jax.tree.unflatten(treedef,
                                 [jnp.asarray(arrays[n]) for n in names])
    return jcfg, cfg, jparams, arrays


def _batch(cfg, t=T, seed=0):
    """tokens, labels ``(B, t)`` int32 and frames ``(B, n_frames,
    d_model)`` f32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, t + 1)).astype(np.int32)
    fr = rng.normal(size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], fr


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -10)
    return float((np.abs(a - b) / np.exp2(np.floor(np.log2(mag)) - 7)).max())


# --------------------------------------------------------------------------
# config, layout, layers
# --------------------------------------------------------------------------


def test_config_fields_match_reference():
    for jcfg, cfg in ((jregistry.get_config(ARCH), registry.get_config(ARCH)),
                      (jregistry.get_reduced_config(ARCH),
                       registry.get_reduced_config(ARCH))):
        for f in ("name", "family", "n_layers", "n_encoder_layers",
                  "n_frames", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "rope_theta", "tie_embeddings", "act",
                  "xent_chunk", "source"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.head_dim_ == jcfg.head_dim_
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
    assert ARCH in registry.list_archs()


@pytest.mark.parametrize("which,leaves,coords", [
    ("get_config", 40, 36_501_504), ("get_reduced_config", 40, 988_416)])
def test_param_specs_are_eval_shapes_order(which, leaves, coords):
    """The leaf order and shapes fix the client workspace: the reference's
    ``jax.eval_shape`` of ``init``, name by name."""
    jcfg, cfg = getattr(jregistry, which)(ARCH), getattr(registry, which)(ARCH)
    shapes = jax.eval_shape(lambda: japi.init(jax.random.key(0), jcfg))
    names, jleaves, _ = checkpoint._flatten_with_names(shapes)
    specs = model_api.param_specs(cfg)
    assert [n for n, _ in specs] == names
    assert [tuple(s) for _, s in specs] == [tuple(a.shape) for a in jleaves]
    assert len(specs) == leaves
    assert sum(math.prod(s) for _, s in specs) == coords
    d = comm_ws.workspace_spec(specs).d_total
    assert d == coords
    if which == "get_reduced_config":
        params = model_api.init(cfg, seed=0, device="cpu")
        assert list(params) == names
        for n, v in params.items():
            if n.endswith(("/bias", "/bk", "/bq", "/bv")):
                assert not v.any(), n
            elif n.endswith("/scale"):
                assert (v == 1).all(), n


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.normal(size=(2, 7, 96))).astype(np.float32)
    scale = rng.normal(size=96).astype(np.float32)
    bias = rng.normal(size=96).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = jl.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jx)
    xt = _t(np.asarray(jx.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    got = layers.layernorm(_t(scale), _t(bias), xt)
    assert got.dtype == xt.dtype
    if dtype == jnp.float32:
        assert _rel(got, want) <= 1e-6
    else:
        assert _bf16_ulps(got.float().numpy(),
                          np.asarray(want, np.float32)) <= 1.0


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_encoder_and_cross_attention_match_reference(dtype):
    """Non-causal self-attention through ``layers.attention(causal=False)``
    against ``attention_fwd(causal=False)``; cross-attention of 9 queries
    over 23 keys and values of another sequence, and the decode form (the
    causal mask at an offset over the valid rows of a cache), through
    ``layers.attention_scores`` against the reference's; the non-causal
    blockwise form against the reference's ``flash_attention``."""
    rng = np.random.default_rng(2)
    d, h, hd = 64, 4, 16

    def arr(*shape):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32)
                           ).astype(dtype)

    def tt(a):
        t = _t(np.asarray(a.astype(jnp.float32)))
        return t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t

    def close(got, want):
        if dtype == jnp.float32:
            return _rel(got, want) <= 1e-6
        return _bf16_ulps(got.float().numpy(),
                          np.asarray(want, np.float32)) <= 1.0

    x = arr(2, 11, d)
    w = {n: jnp.asarray(rng.normal(size=s).astype(np.float32) / 8) for n, s
         in (("wq", (d, h * hd)), ("wk", (d, h * hd)), ("wv", (d, h * hd)),
             ("wo", (h * hd, d)), ("bq", (h * hd,)), ("bk", (h * hd,)),
             ("bv", (h * hd,)))}
    want = jl.attention_fwd(w, x, n_heads=h, n_kv_heads=h, head_dim=hd,
                            rope_theta=None, causal=False)
    wt = {k: _t(np.asarray(v)) for k, v in w.items()}
    got = layers.attention(tt(x), wt["wq"], wt["wk"], wt["wv"], wt["wo"],
                           n_heads=h, n_kv_heads=h, head_dim=hd,
                           rope_theta=None, window=0, attn_softcap=None,
                           biases=(wt["bq"], wt["bk"], wt["bv"]),
                           causal=False)
    assert close(got, want)

    q, k, v = arr(2, 9, h, hd), arr(2, 23, 2, hd), arr(2, 23, 2, hd)
    want = jl.attention_scores(q, k, v, causal=False)
    assert close(layers.attention_scores(tt(q), tt(k), tt(v)), want)
    q1 = arr(2, 1, h, hd)
    want = jl.attention_scores(q1, k, v, causal=True, q_offset=13,
                               kv_valid_len=14)
    got = layers.attention_scores(tt(q1), tt(k), tt(v), causal=True,
                                  q_offset=13, kv_len=14)
    assert close(got, want)
    # an encoder past FLASH_THRESHOLD frames takes the blockwise form,
    # non-causal as the reference's (small key chunks here)
    qf, kf, vf = arr(2, 37, h, hd), arr(2, 37, 2, hd), arr(2, 37, 2, hd)
    assert close(layers.flash_attention(tt(qf), tt(kf), tt(vf), window=0,
                                        attn_softcap=None, k_chunk=16,
                                        causal=False),
                 jl.flash_attention(qf, kf, vf, causal=False, k_chunk=16))
    # rows past the valid length are not read
    k2 = tt(k).clone()
    k2[:, 14:] = float("nan")
    got2 = layers.attention_scores(tt(q1), k2, tt(v), causal=True,
                                   q_offset=13, kv_len=14)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ungated_mlp_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 5, 48)).astype(np.float32)
                    ).astype(dtype)
    w_up = rng.normal(size=(48, 96)).astype(np.float32) / 7
    w_down = rng.normal(size=(96, 48)).astype(np.float32) / 10
    want = jl.mlp_fwd({"w_up": jnp.asarray(w_up),
                       "w_down": jnp.asarray(w_down)}, x, act="gelu")
    xt = _t(np.asarray(x.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    got = layers.mlp(xt, None, _t(w_up), _t(w_down), "gelu")
    if dtype == jnp.float32:
        assert _rel(got, want) <= 1e-6
    else:
        assert _bf16_ulps(got.float().numpy(),
                          np.asarray(want, np.float32)) <= 1.0


def test_sinusoid_matches_the_references_eager_table():
    """At whisper-tiny's (1500, 384): the port's table within 4e-6 of the
    reference's eager table, the jitted table up to 8.6e-5 from it (module
    docstring; held under 2e-4 here, above the port's 4e-6), all three
    ~1.07e-4 from float64; the decode step's single-position form, from
    the scalar ``pos``, is the table's row bit for bit in the port and
    within 4e-6 of the reference's own scalar form."""
    t, d = 1500, 384
    eager = np.asarray(jenc.sinusoidal_positions(t, d))
    jitted = np.asarray(jax.jit(jenc.sinusoidal_positions,
                                static_argnums=(0, 1))(t, d))
    got = layers.sinusoid(torch.arange(t), d, torch.float32).numpy()
    assert np.abs(got - eager).max() <= 4e-6
    jit_err = np.abs(jitted - eager).max()
    assert 4e-6 < jit_err < 2e-4, jit_err
    pos = np.arange(t, dtype=np.float64)[:, None]
    angle = pos / np.power(10000.0, 2 * np.arange(d // 2) / d)
    f64 = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    for table in (eager, jitted, got):
        assert 5e-5 < np.abs(table - f64).max() < 2e-4
    for p in (0, 1, 447, 1499):
        row = layers.sinusoid(torch.tensor([p]), d, torch.float32)[0]
        assert torch.equal(row, torch.from_numpy(got[p]))
        dim = jnp.arange(d // 2, dtype=jnp.float32)
        angle = jnp.asarray(p, jnp.float32) / jnp.power(10000.0,
                                                        2 * dim / d)
        ref = np.asarray(jnp.concatenate([jnp.sin(angle), jnp.cos(angle)]))
        assert np.abs(row.numpy() - ref).max() <= 4e-6, p


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def test_loss_and_grads_match_reference():
    """The f32 loss and every per-leaf gradient under ``jax.jit`` of
    ``jax.grad`` of ``model_api.loss`` (module docstring for the key
    biases)."""
    jcfg, cfg, jparams, arrays = _weights()
    tokens, labels, fr = _batch(cfg)
    jl_, jg = jax.jit(jax.value_and_grad(lambda p: japi.loss(
        p, jcfg, tokens=jnp.asarray(tokens), labels=jnp.asarray(labels),
        frames=jnp.asarray(fr))[0]))(jparams)
    names, jleaves, _ = checkpoint._flatten_with_names(jg)
    params = {k: v.requires_grad_(True) for k, v in
              convert.params_from_numpy(arrays, cfg, "cpu").items()}
    loss, metrics = model_api.loss(params, cfg, tokens=_t(tokens).long(),
                                   labels=_t(labels).long(), frames=_t(fr))
    assert set(metrics) == {"xent"}
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(jl_)) <= 1e-5 * abs(float(jl_))
    assert list(params) == names
    top = max(float(np.abs(np.asarray(w)).max()) for w in jleaves)
    for name, g, want in zip(names, grads, jleaves):
        want = np.asarray(want, np.float32)
        if name.endswith("/bk"):
            assert np.abs(want).max() <= 1e-7 * top, name
            assert float(g.abs().max()) <= 1e-7 * top, name
            continue
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-5, (name, err)


def _op_by_op_loss(params, jcfg, frames, tokens, labels):
    """The reference's ``encdec.loss_fn`` with its layer scans unrolled,
    for an un-jitted (op-by-op) evaluation."""
    kw = dict(n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads,
              head_dim=jcfg.head_dim_, rope_theta=None)
    x = frames.astype(jcfg.dtype)
    x = x + jenc.sinusoidal_positions(x.shape[1], jcfg.d_model,
                                      jcfg.dtype)[None]
    for l in range(jcfg.n_encoder_layers):
        bp = jax.tree.map(lambda a: a[l], params["enc_blocks"])
        x = x + jl.attention_fwd(bp["attn"], jl.layernorm(bp["ln_attn"], x),
                                 causal=False, **kw)
        x = x + jl.mlp_fwd(bp["mlp"], jl.layernorm(bp["ln_ff"], x),
                           act="gelu")
    enc = jl.layernorm(params["enc_norm"], x)
    x = params["embed"].astype(jcfg.dtype)[tokens]
    x = x + jenc.sinusoidal_positions(x.shape[1], jcfg.d_model,
                                      jcfg.dtype)[None]
    for l in range(jcfg.n_layers):
        bp = jax.tree.map(lambda a: a[l], params["dec_blocks"])
        x = x + jl.attention_fwd(bp["attn"], jl.layernorm(bp["ln_attn"], x),
                                 causal=True, **kw)
        x = x + jenc._cross_attend(bp, x, enc, jcfg, precomputed=False)
        x = x + jl.mlp_fwd(bp["mlp"], jl.layernorm(bp["ln_ff"], x),
                           act="gelu")
    h = jl.layernorm(params["final_norm"], x)
    return jl.chunked_softmax_xent(h, params["embed"].T, labels,
                                   chunk=jcfg.xent_chunk,
                                   valid_vocab=jcfg.vocab)


def test_bf16_loss_matches_reference_op_by_op():
    """bf16 compute against the reference evaluated op by op, within
    ``tests/test_torch_family.py``'s 5e-5 relative."""
    jcfg, cfg, jparams, arrays = _weights(jnp.bfloat16)
    tokens, labels, fr = _batch(cfg)
    want = float(_op_by_op_loss(jparams, jcfg, jnp.asarray(fr),
                                jnp.asarray(tokens), jnp.asarray(labels)))
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    with torch.no_grad():
        got, _ = model_api.loss(params, cfg, tokens=_t(tokens).long(),
                                labels=_t(labels).long(), frames=_t(fr))
    assert abs(got.item() - want) <= 5e-5 * abs(want), (got.item(), want)


def test_the_references_value_errors():
    """``loss`` without frames, with a prefix, and frames for another
    family: the reference's three ``ValueError`` texts."""
    _, cfg, _, arrays = _weights()
    jcfg = jregistry.get_reduced_config(ARCH)
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    tokens, labels, fr = _batch(cfg, t=4)
    tk, lb = _t(tokens).long(), _t(labels).long()
    pe = torch.zeros(B, 2, cfg.d_model)
    jtk, jlb = jnp.asarray(tokens), jnp.asarray(labels)
    gcfg = registry.get_reduced_config("gemma2-2b")
    jgcfg = jregistry.get_reduced_config("gemma2-2b")
    cases = [
        (lambda: model_api.loss(params, cfg, tokens=tk, labels=lb),
         lambda: japi.loss({}, jcfg, tokens=jtk, labels=jlb)),
        (lambda: model_api.loss(params, cfg, tokens=tk, labels=lb,
                                frames=_t(fr), prefix_embeds=pe),
         lambda: japi.loss({}, jcfg, tokens=jtk, labels=jlb,
                           frames=jnp.asarray(fr),
                           prefix_embeds=jnp.zeros((B, 2, cfg.d_model)))),
        (lambda: model_api.loss({}, gcfg, tokens=tk, labels=lb,
                                frames=_t(fr)),
         lambda: japi.loss({}, jgcfg, tokens=jtk, labels=jlb,
                           frames=jnp.asarray(fr))),
    ]
    for port, ref in cases:
        with pytest.raises(ValueError) as want:
            ref()
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            port()


def _port_decode(params, cfg, fr, tokens, kv_dtype, cache=None, start=0):
    if cache is None:
        cache = model_api.make_cache(cfg, B, tokens.shape[1], kv_dtype,
                                     device="cpu")
        fr = fr if isinstance(fr, torch.Tensor) else _t(fr)
        cache = serve.fill_cross_kv(params, cfg, cache, fr)
    out = []
    with torch.no_grad():
        for i in range(start, tokens.shape[1]):
            lg, cache = model_api.decode(params, cfg,
                                         _t(tokens[:, i:i + 1]).long(),
                                         cache, i)
            out.append(lg)
    return out, cache


def test_decode_matches_teacher_forcing():
    """The port's ``tests/test_decode_consistency.py``
    ``test_encdec_decode_matches_teacher_forcing``: the decode steps'
    log-probabilities against the teacher-forced forward's at every
    position, in f32 within 2e-5 (the reference's test allows 5e-3)."""
    _, cfg, _, arrays = _weights()
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    tokens, _, fr = _batch(cfg, t=24, seed=4)
    with torch.no_grad():
        enc = encdec.encode(params, cfg, _t(fr))
        h = encdec.decode_train(params, cfg, _t(tokens).long(), enc)
        lt = (h.float() @ params["embed"].T.float())[..., :cfg.vocab]
        prefill = model_api.prefill(params, cfg, tokens=_t(tokens).long(),
                                    frames=_t(fr))
    assert _rel(prefill, lt[:, -1].numpy()) <= 1e-6
    steps, _ = _port_decode(params, cfg, fr, tokens, torch.float32)
    ld = torch.stack(steps, dim=1)
    err = float((torch.log_softmax(lt, -1) - torch.log_softmax(ld, -1))
                .abs().max())
    assert err < 2e-5, err


@pytest.fixture(scope="module")
def reference_decode():
    """The reference's decode of 24 tokens on an f32 cache, and on a bf16
    cache with a snapshot before step 17 (its cross K/V precomputed, as its
    serving CLI does)."""
    jcfg, cfg, jparams, arrays = _weights()
    tokens, _, fr = _batch(cfg, t=24, seed=4)
    jstep = jax.jit(lambda p, t, c, pos: japi.decode(p, jcfg, t, c, pos))
    enc = jax.jit(lambda p, f: jenc.encode(p, jcfg, f))(jparams,
                                                         jnp.asarray(fr))
    out = {}
    for kv in (jnp.float32, jnp.bfloat16):
        cache = japi.make_cache(jcfg, B, tokens.shape[1], kv_dtype=kv)
        cache = jenc.precompute_cross_kv(jparams, jcfg, enc, cache)
        logits, snap = [], None
        for i in range(tokens.shape[1]):
            if i == 17:
                snap = {k: np.asarray(v) for k, v in cache.items()}
            lg, cache = jstep(jparams, jnp.asarray(tokens[:, i:i + 1]),
                              cache, jnp.asarray(i, jnp.int32))
            logits.append(np.asarray(lg))
        out[kv] = (logits, snap, {k: np.asarray(v) for k, v in
                                  cache.items()})
    return dict(cfg=cfg, arrays=arrays, tokens=tokens, fr=fr, out=out)


def test_decode_matches_the_references_decode_step(reference_decode):
    """24 steps on an f32 cache: logits within 2e-5 of the largest, the
    self and cross K/V within 1e-5; attend_fn is not read."""
    r = reference_decode
    params = convert.params_from_numpy(r["arrays"], r["cfg"], "cpu")
    got, cache = _port_decode(params, r["cfg"], r["fr"], r["tokens"],
                              torch.float32)
    want, _, jcache = r["out"][jnp.float32]
    for g, w in zip(got, want):
        assert _rel(g, w) <= 2e-5
    for name in ("k", "v", "xk", "xv"):
        assert _rel(cache[name], jcache[name]) <= 1e-5, name

    def boom(*a, **k):
        raise AssertionError("the encoder-decoder takes no attend_fn")

    c2 = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        a, _ = model_api.decode(params, r["cfg"],
                                _t(r["tokens"][:, -1:]).long(), cache, 23)
        b, _ = model_api.decode(params, r["cfg"],
                                _t(r["tokens"][:, -1:]).long(), c2, 23,
                                attend_fn=boom)
    assert torch.equal(a, b)


def test_decode_from_the_references_bf16_cache(reference_decode):
    """The reference's bf16 cache before step 17 (self and cross K/V),
    carried over bit for bit by ``cache_from_numpy``; the port's steps 17
    to 23 from it within 2e-5 of the reference's logits, the rows written
    at each step within one bf16 ulp."""
    r = reference_decode
    want, snap, jcache = r["out"][jnp.bfloat16]
    cache = convert.cache_from_numpy(snap, device="cpu")
    for name in ("k", "v", "xk", "xv"):
        assert cache[name].dtype == torch.bfloat16
        assert np.array_equal(
            cache[name].view(torch.int16).numpy().view(np.uint16),
            np.ascontiguousarray(snap[name]).view(np.uint16)), name
    params = convert.params_from_numpy(r["arrays"], r["cfg"], "cpu")
    got, cache = _port_decode(params, r["cfg"], r["fr"], r["tokens"], None,
                              cache=cache, start=17)
    for g, w in zip(got, want[17:]):
        assert _rel(g, w) <= 2e-5
    for name in ("k", "v"):
        a = cache[name][:, :, 17:].float().numpy()
        b = np.asarray(jcache[name][:, :, 17:], np.float32)
        assert _bf16_ulps(a, b) <= 1.0, name


# --------------------------------------------------------------------------
# the round, the pipeline, serving
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_round_fns(microbatches):
    """The reference's config, mesh and jitted local and comm steps, built
    once for the tests that run its round."""
    jcfg = jregistry.get_reduced_config(ARCH)
    tcfg = jtd.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34,
                                microbatches=microbatches)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return dict(jcfg=jcfg, tcfg=tcfg, mesh=mesh,
                local=jax.jit(jtd.make_local_step(jcfg, tcfg)),
                comm=jax.jit(jtd.make_comm_step(jcfg, tcfg, mesh, impl="ws",
                                                n=N)))


def _round_reference(microbatches):
    fns = _reference_round_fns(microbatches)
    jcfg = fns["jcfg"]
    names, leaves, treedef = checkpoint._flatten_with_names(
        japi.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(7)
    x0 = [np.asarray(a)[None] + 0.01 * rng.normal(
        size=(N,) + a.shape).astype(np.float32) for a in leaves]
    h0 = [0.01 * rng.normal(size=(N,) + a.shape).astype(np.float32)
          for a in leaves]
    h0 = [(a - a.mean(axis=0, keepdims=True)).astype(np.float32)
          for a in h0]
    toks = rng.integers(0, jcfg.vocab, size=(L, C, B, 24 + 1))
    frames = rng.normal(size=(L, C, B, jcfg.n_frames, jcfg.d_model)
                        ).astype(np.float32)
    key = jax.random.key_data(jax.random.key(11))
    _, k_perm = jax.random.split(jax.random.wrap_key_data(key))
    perm = np.asarray(jax.random.permutation(k_perm, C))
    x0[names.index("embed")][1] = np.nan  # an idle row may hold anything
    return dict(fns, names=names, treedef=treedef, x0=x0, h0=h0,
                toks=toks.astype(np.int32), frames=frames, key=key,
                perm=perm)


def _run_round_reference(ref):
    unflat = lambda ls: jax.tree.unflatten(ref["treedef"],
                                           [jnp.asarray(a) for a in ls])
    zero = jnp.zeros((), jnp.float32)
    state = jtd.DistTamunaState(
        x=unflat(ref["x0"]), h=unflat(ref["h0"]), opt=(),
        round=jnp.zeros((), jnp.int32), up_floats=zero, down_floats=zero,
        up_bytes=zero, down_bytes=zero)
    local, comm = ref["local"], ref["comm"]
    cohort = jnp.asarray(COHORT, jnp.int32)
    compact = jtd.gather_cohort(state, cohort)
    for t in range(L):
        tk = jnp.asarray(ref["toks"][t])
        compact, _ = local(compact, tokens=tk[..., :-1], labels=tk[..., 1:],
                           frames=jnp.asarray(ref["frames"][t]))
    state = jtd.scatter_cohort(state, compact, cohort)
    return comm(state, ref["key"], cohort=cohort, down=jnp.asarray(DOWN))


def _run_round_port(ref, microbatches):
    cfg = registry.get_reduced_config(ARCH)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34,
                                      microbatches=microbatches)
    spec = tamuna_dp.state_spec(cfg, tcfg)
    assert list(spec.names) == ref["names"]
    x = torch.empty(N, spec.d_total)
    h = torch.empty(N, spec.d_total)
    for ws, arrs in ((x, ref["x0"]), (h, ref["h0"])):
        comm_ws.pack({n: torch.from_numpy(a) for n, a in
                      zip(ref["names"], arrs)}, spec, ws)
    state = tamuna_dp.DistTamunaState(x=x, h=h, spec=spec)
    local = tamuna_dp.make_local_step(cfg, tcfg)
    compact = tamuna_dp.gather_cohort(state, COHORT)
    for t in range(L):
        tk = torch.from_numpy(ref["toks"][t]).long()
        local(compact, tokens=tk[..., :-1], labels=tk[..., 1:],
              frames=torch.from_numpy(ref["frames"][t]))
    state = tamuna_dp.scatter_cohort(state, compact)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, N, device="cpu")
    return comm(state, COHORT, ref["perm"].tolist(), torch.from_numpy(DOWN))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_round_matches_reference_per_step_composition(microbatches):
    """One round (n=4, c=3, s=2, two local steps of 24 tokens) with the
    cohort, the permutation from the reference's comm key, the DownCom
    rows, the batches and the frames injected (with 2 microbatches the
    frames split with the tokens): x and h within 1e-5, the idle row
    bit-exact, sum_i h_i = 0, the counters within 1e-5 relative."""
    ref = _round_reference(microbatches)
    want = _run_round_reference(ref)
    got = _run_round_port(ref, microbatches)
    gx = comm_ws.unpack(got.x, got.spec)
    gh = comm_ws.unpack(got.h, got.spec)
    for name, wx, wh in zip(ref["names"], jax.tree.leaves(want.x),
                            jax.tree.leaves(want.h)):
        wx, wh = np.asarray(wx), np.asarray(wh)
        live = ~np.isnan(wx)
        assert np.array_equal(np.isnan(gx[name].numpy()), ~live), name
        assert np.abs(gx[name].numpy()[live] - wx[live]).max() <= 1e-5, name
        assert np.abs(gh[name].numpy() - wh).max() <= 1e-5, name
    x0f = np.concatenate([a.reshape(N, -1) for a in ref["x0"]], axis=1)
    h0f = np.concatenate([a.reshape(N, -1) for a in ref["h0"]], axis=1)
    assert got.x[1].numpy().tobytes() == x0f[1].tobytes()
    assert got.h[1].numpy().tobytes() == h0f[1].tobytes()
    assert np.abs(got.h.sum(0).numpy()).max() < 1e-6
    for k in ("up_floats", "down_floats", "up_bytes", "down_bytes"):
        w = float(getattr(want, k))
        assert abs(getattr(got, k) - w) <= 1e-5 * w, k


def _rounding_of(ref, x_leaves, h_leaves, spec):
    """``tamuna_dp.h_sum_rounding`` of one round on reference leaves packed
    as the port's workspaces (max|x| over the cohort: the idle row holds
    NaN), and |sum_i h_i| / max|h|."""
    x, h = torch.empty(N, spec.d_total), torch.empty(N, spec.d_total)
    for ws, arrs in ((x, x_leaves), (h, h_leaves)):
        comm_ws.pack({n: torch.from_numpy(np.asarray(a)) for n, a in
                      zip(ref["names"], arrs)}, spec, ws)
    state = tamuna_dp.DistTamunaState(x=x, h=h, spec=spec)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34)
    return (*tamuna_dp.h_sum_rounding(state, tcfg, N, 1, rows=COHORT),
            float(h.sum(0).abs().max() / h.abs().max()))


def test_round_h_sum_is_f32_rounding_and_a_lost_owner_is_not(monkeypatch,
                                                              capsys):
    """The round above (microbatches 1) from h = 0: in both the port and
    the reference every leaf's |sum_i h_i| lies within its f32 rounding
    bound (``tamuna_dp.h_sum_rounding``, one round); with one owner's h
    update dropped (a lost owner, planted in the port's
    ``uplink.h_update``) it lies over 1000 times its bound.  Prints the
    readings and |sum_i h_i| / max|h|."""
    ref = _round_reference(1)
    ref["h0"] = [np.zeros_like(a) for a in ref["h0"]]
    want = _run_round_reference(ref)
    got = _run_round_port(ref, 1)
    leaves = lambda ws: [a.numpy() for a in comm_ws.unpack(
        ws, got.spec).values()]
    port = _rounding_of(ref, leaves(got.x), leaves(got.h), got.spec)
    jref = _rounding_of(ref, jax.tree.leaves(want.x),
                        jax.tree.leaves(want.h), got.spec)
    h_update = uplink.h_update

    def lost_owner(x, h, x_bar, slot, band, m, *args, **kw):
        slot = slot.clone()
        slot[int(((slot >= 0) & (slot < m)).nonzero()[0])] = -1
        h_update(x, h, x_bar, slot, band, m, *args, **kw)

    monkeypatch.setattr(uplink, "h_update", lost_owner)
    got = _run_round_port(ref, 1)
    lost = _rounding_of(ref, leaves(got.x), leaves(got.h), got.spec)
    with capsys.disabled():
        for tag, r in (("port", port), ("reference", jref),
                       ("a lost owner", lost)):
            print(f"\n[h_sum] one reduced round, {tag}: {r[0]:.4g} of the "
                  f"bound, {r[1]:.4g} ulps of max|x| ({r[2]}); "
                  f"|sum h|/max|h| {r[3]:.4g}", end="")
    assert port[0] <= 1 and jref[0] <= 1
    assert lost[0] > 1000


def test_pipeline_draws_frames_after_the_tokens():
    """``frames (c, b, n_frames, d_model)`` in the compute dtype, drawn
    from the pipeline's generator after the tokens: the tokens are those
    of a model without frames, and the frames the next normal draws."""
    cfg = registry.get_reduced_config(ARCH)
    dcfg = DataConfig(seq_len=8, per_client_batch=2, vocab=64, seed=3,
                      n_clients=4)
    got = SyntheticTokenPipeline(dcfg, cfg, "cpu").sample_batch([0, 2, 3])
    plain_cfg = dataclasses.replace(registry.get_reduced_config("gemma2-2b"),
                                    vocab=cfg.vocab)
    plain = SyntheticTokenPipeline(dcfg, plain_cfg, "cpu")
    want = plain.sample_batch([0, 2, 3])
    assert set(got) == {"tokens", "labels", "frames"}
    assert torch.equal(got["tokens"], want["tokens"])
    assert got["frames"].shape == (3, 2, cfg.n_frames, cfg.d_model)
    assert got["frames"].dtype == cfg.dtype
    nxt = torch.randn((3, 2, cfg.n_frames, cfg.d_model),
                      generator=plain.generator)
    assert torch.equal(got["frames"], nxt)


def test_train_cli_and_the_pipelined_rounds_train_whisper(capsys):
    """The train CLI's ``main`` in this process: the synchronous rounds and
    the pipelined rounds at staleness 1 (the batches carry the frames)."""
    assert train.main(["--arch", ARCH, "--reduced", "--rounds", "2",
                       "--seq-len", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"on cpu in [0-9.]+s; final loss (\S+)$", out.strip())
    assert m and math.isfinite(float(m.group(1))), out
    assert train.main(["--arch", ARCH, "--reduced", "--rounds", "3",
                       "--seq-len", "16", "--clients", "6", "--cohort", "2",
                       "--pipeline", "--staleness", "1", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert "simulated clock" in out
    m = re.search(r"final loss (\S+)$", out.strip())
    assert m and math.isfinite(float(m.group(1))), out


def test_serve_cli_serves_whisper_on_cpu(capsys):
    """``launch.serve``'s ``main`` in this process: the encoder and the
    cross K/V timed apart, then the greedy continuations."""
    assert serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--gen-len", "3", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] encoder and cross K/V over 64 frames: "
                     r"[0-9.]+s", out), out
    line = out.strip().splitlines()[-1]
    assert line.startswith("[serve] sample continuations: [[")
    assert np.asarray(json.loads(line.split(":", 1)[1])).shape == (2, 3)
    frames = serve.make_frames(2, registry.get_reduced_config(ARCH), "cpu")
    want = np.random.default_rng(7).standard_normal((2, 64, 128),
                                                    dtype=np.float32)
    assert np.array_equal(frames.numpy(), want)


def test_serving_cast_keeps_the_layernorm_biases_and_the_bits():
    """``cast_for_serving_`` on a bf16 whisper-tiny-reduced keeps the
    layernorm scales and biases in f32 (the reference reads them as f32)
    and casts the rest, the attention biases too (added in the compute
    dtype); 6 decode steps from the encoded frames give the same logits
    and cache, bit for bit, as the f32 parameters'."""
    cfg = dataclasses.replace(registry.get_reduced_config(ARCH),
                              dtype=torch.bfloat16)
    _, _, _, arrays = _weights()
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    f32 = {k: v.clone() for k, v in params.items()}
    serve_utils.cast_for_serving_(params, cfg)
    for k, v in params.items():
        keep = "/ln_" in k or k.startswith(("enc_norm/", "final_norm/"))
        assert v.dtype == (torch.float32 if keep else torch.bfloat16), k
        assert torch.equal(v, f32[k].to(v.dtype)), k
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, 6))
    fr = serve.make_frames(B, cfg, "cpu")
    out = [_port_decode(p, cfg, fr, toks, torch.bfloat16)
           for p in (f32, params)]
    (la, ca), (lb, cb) = out
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    for k in ca:
        assert torch.equal(ca[k], cb[k]), k
