"""The port's attention at and past ``FLASH_THRESHOLD`` (2048) against the
reference's blockwise ``flash_attention``, which the reference's forward
takes from that length on (``repro.models.transformer`` at t >= 2048).

The blockwise form scales q in its own dtype before the logits, keeps the
probabilities in f32 into the product with v and walks 1024-key chunks
with an online softmax; the dense form below 2048 rounds the probabilities
to the compute dtype.  In bf16 the two differ by far more than the port
and the reference do, so each comparison also shows the dense form
failing its tolerance.

Tolerances (measured on the CPU): the bare attention, bf16 q/k/v at the
reduced config's heads, within one bf16 ulp on every element and at most
0.1% of them differing (measured 0.03-0.05%; the dense form differs on
~41%); the attention block with its projections and RoPE, within 2e-3 of
the largest output and at most 20% of the elements differing (measured
1.1e-3 and 8-11%; dense 4.3e-3 and 50%).  The model's loss and gradients
at t = 2048: f32 within 1e-6 relative and 1e-4 of each leaf's largest
gradient (measured exact and 4.1e-5: longer sums than the 1e-5 of
tests/test_torch_model.py at t = 96); bf16, where the two frameworks round
activations at other places in every layer, within 5e-5 relative and
5e-2 (measured 1.1e-5 and 3.1e-2).  Prefill logits in bf16 within 3e-2 of
the largest (measured 2.1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import gemma2_2b as jgemma
from repro.dist import model_api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import gemma2_2b
from repro_torch.dist import model_api
from repro_torch.models import layers

# the reduced gemma2-2b config's attention
H, KVH, HD, SOFTCAP = 4, 2, 64, 50.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, shape):
    return rng.normal(size=shape).astype(ml_dtypes.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _ulps(a, b):
    """|a - b| in bf16 ulps of the larger magnitude (at least 2^-10)."""
    mag = np.maximum(np.abs(a), np.abs(b)).clip(2.0 ** -10)
    return np.abs(a - b) / np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.fixture
def dense_attention(monkeypatch):
    """``layers.attention`` with the switch moved out of reach: the dense
    form the port took at every length before."""
    def run(*args, **kw):
        with monkeypatch.context() as m:
            m.setattr(layers, "FLASH_THRESHOLD", 10 ** 12)
            return layers.attention(*args, **kw)
    return run


@pytest.mark.parametrize("window", [64, None])
@pytest.mark.parametrize("t", [2048, 2500])
def test_flash_attention_matches_reference_flash(t, window):
    """bf16 q, k, v at the reduced config's heads; t = 2500 leaves a
    ragged last chunk of 452 keys.  The dense softmax with bf16
    probabilities on the same inputs falls outside the tolerance."""
    rng = np.random.default_rng(t + (window or 0))
    q, k, v = (_bf16(rng, (1, t, h, HD)) for h in (H, KVH, KVH))
    w = t + 1 if window is None else window
    want = np.asarray(jax.jit(lambda q, k, v: jlayers.flash_attention(
        q, k, v, causal=True, window=jnp.int32(w), attn_softcap=SOFTCAP))(
            q, k, v), np.float32)
    tq, tk, tv = map(_torch_bf16, (q, k, v))
    got = layers.flash_attention(tq, tk, tv, window=w,
                                 attn_softcap=SOFTCAP)
    assert got.dtype == torch.bfloat16
    u = _ulps(got.float().numpy(), want)
    assert u.max() <= 1.0 and (u > 0).mean() <= 1e-3

    # the dense form: logits / sqrt(hd), softmax, probabilities to bf16
    qg = tq.view(1, t, KVH, H // KVH, HD).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, tk.float()) / HD ** 0.5
    logits = SOFTCAP * torch.tanh(logits / SOFTCAP)
    qp, kp = torch.arange(t)[:, None], torch.arange(t)[None, :]
    logits = logits.masked_fill(~((kp <= qp) & (kp > qp - w)), -1e30)
    probs = torch.softmax(logits, dim=-1).bfloat16()
    dense = torch.einsum("bkgts,bskd->btkgd", probs, tv).reshape(1, t, H, HD)
    ud = _ulps(dense.float().numpy(), want)
    assert ud.max() > 1.0 and (ud > 0).mean() > 1e-3


@pytest.mark.parametrize("window", [64, None])
def test_attention_block_past_the_threshold_matches_reference(
        window, dense_attention):
    """The attention block (projections, RoPE, attention, output
    projection) in bf16 at t = 2500 against the reference's
    ``_attention_with_dyn_window``, which takes ``flash_attention``
    there; the old dense form fails the same tolerance."""
    t = 2500
    jcfg = dataclasses.replace(jgemma.REDUCED, dtype=jnp.bfloat16)
    rng = np.random.default_rng(7)
    x = _bf16(rng, (1, t, jcfg.d_model))
    params = japi.init(jax.random.key(0), jcfg)
    ap = {n: np.array(params["blocks"]["attn"][n][0])
          for n in ("wq", "wk", "wv", "wo")}
    w = t + 1 if window is None else window
    want = np.asarray(jax.jit(lambda ap, x: jtr._attention_with_dyn_window(
        ap, x, jcfg, jnp.int32(w)))(ap, x), np.float32)
    kw = dict(n_heads=H, n_kv_heads=KVH, head_dim=HD,
              rope_theta=jcfg.rope_theta, window=w, attn_softcap=SOFTCAP)
    args = (_torch_bf16(x),) + tuple(torch.from_numpy(ap[n]) for n in
                                     ("wq", "wk", "wv", "wo"))
    top = np.abs(want).max()

    def within(out):
        out = out.float().numpy()
        return (np.abs(out - want).max() <= 2e-3 * top
                and (_ulps(out, want) > 0).mean() <= 0.2)

    assert within(layers.attention(*args, **kw))
    assert not within(dense_attention(*args, **kw))


def test_attention_takes_the_blockwise_path_from_2048(monkeypatch):
    """The switch is the reference's: 2047 tokens take the dense form,
    2048 the blockwise one."""
    calls = []
    real = layers.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    assert layers.FLASH_THRESHOLD == jlayers.FLASH_THRESHOLD == 2048
    g = torch.Generator().manual_seed(0)
    d = 32
    ws = [torch.randn(d, H * 8, generator=g) for _ in range(3)]
    ws[1], ws[2] = ws[1][:, :KVH * 8], ws[2][:, :KVH * 8]
    wo = torch.randn(H * 8, d, generator=g)
    for t in (2047, 2048):
        x = torch.randn(1, t, d, generator=g)
        layers.attention(x, *ws, wo, n_heads=H, n_kv_heads=KVH, head_dim=8,
                         rope_theta=None, window=t + 1, attn_softcap=None)
    assert calls == [2048]


def _reduced(dtype):
    jcfg = dataclasses.replace(jgemma.REDUCED, dtype=dtype)
    cfg = dataclasses.replace(
        gemma2_2b.REDUCED,
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    params = japi.init(jax.random.key(0), jcfg)
    names, leaves, _ = checkpoint._flatten_with_names(params)
    arrays = {n: np.asarray(a) for n, a in zip(names, leaves)}
    return jcfg, cfg, params, names, arrays


@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    (jnp.float32, 1e-6, 1e-4), (jnp.bfloat16, 5e-5, 5e-2)])
def test_loss_and_grads_at_the_threshold_match_reference(dtype, loss_tol,
                                                         grad_tol):
    t = layers.FLASH_THRESHOLD
    jcfg, cfg, jparams, names, arrays = _reduced(dtype)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(1, t)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(1, t)).astype(np.int32)

    def jloss(p):
        return japi.loss(p, jcfg, tokens=jnp.asarray(tokens),
                         labels=jnp.asarray(labels))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    _, jleaves, _ = checkpoint._flatten_with_names(jg)
    params = {k: v.requires_grad_(True) for k, v in
              convert.params_from_numpy(arrays, cfg, "cpu").items()}
    loss, _ = model_api.loss(params, cfg,
                             tokens=torch.from_numpy(tokens).long(),
                             labels=torch.from_numpy(labels).long())
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    assert abs(loss.item() - float(jl)) <= loss_tol * abs(float(jl))
    for name, w in zip(names, jleaves):
        w = np.asarray(w, np.float32)
        g = grads[name].float().numpy()
        assert np.abs(g - w).max() <= grad_tol * np.abs(w).max(), name


def test_prefill_at_the_threshold_matches_reference():
    t = layers.FLASH_THRESHOLD
    jcfg, cfg, jparams, _, arrays = _reduced(jnp.bfloat16)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(1, t)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p: japi.prefill(
        p, jcfg, tokens=jnp.asarray(tokens)))(jparams), np.float32)
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    with torch.no_grad():
        got = model_api.prefill(params, cfg,
                                tokens=torch.from_numpy(tokens).long())
    got = got.float().numpy()
    assert got.shape == want.shape == (1, cfg.vocab)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
