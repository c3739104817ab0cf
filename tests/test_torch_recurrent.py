"""The RWKV-6 and Mamba2-hybrid families in the port against the reference
(``repro.models.ssm``, ``repro.models.rwkv`` and the rwkv6-7b / zamba2-2.7b
reduced configs).

Inputs are numpy-seeded; the layer tests draw their own weights (the
reference's constant inits, such as ``A_log = 0`` or ``u = 0.5``, get
random values so each leaf is seen) and the model tests carry the
reference's init over with ``repro_torch.convert``.  Tolerances, each
against the largest entry of what is compared: the scan, the decode step
and the layers within 1e-5 in f32 (float64 is not what either side
computes); the reduced rwkv6-7b's loss within 1e-5 relative and its
gradients within 2e-5 (measured 8e-6); zamba2-2.7b's loss within 1e-5 and
its gradients within 1e-4: its chunked scan multiplies by ``exp(-L)`` and
``exp(P)`` factors of e^40 and more, and both frameworks' f32 gradients lie
2e-5 to 6e-5 from a float64 evaluation (the port's held to at most twice
the reference's distance plus 1e-6 below); decode within 2e-5 (rwkv) and
5e-5 (zamba2, measured 1.7e-5) of the largest logit, against the port's
own teacher-forced forward within 1e-4 in log-probabilities.  bf16 rwkv6
against the reference evaluated op by op (``tests/test_torch_family.py``'s
way): each layer's bf16 operations agree bitwise but XLA's f32 ``exp``
differs from torch's by an ulp on ~20% of the decays, the scan's e^23
factors carry that to ~1e-5 in its output, and its rounding to bf16 then
differs on ~0.5% of the time-mix's outputs (measured on the CPU); so the
loss within 2e-4 (measured 5.4e-5 at t = 32) and each gradient within
0.15 of its largest entry (measured 0.107 on ``tm/u``; both bf16
evaluations lie 2-9% from the f32 gradients).

The reference's scan overflows f32 where a chunk's cumulative log-decay
passes -88 (``exp(-L)`` is inf and ``0 * inf`` NaN); at zamba2's init that
happens within a 64-token chunk, so its model tests run at t = 32 and a
test holds the port to the same NaNs on an overflowing input.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import registry as jregistry
from repro.dist import model_api as japi
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist import model_api
from repro_torch.models import rwkv, ssm
from repro_torch.models import transformer as tr

ARCHS = ["rwkv6-7b", "zamba2-2.7b"]
B = 2
# zamba2's model tests stay inside one chunk's f32 range (module docstring)
T = {"rwkv6-7b": 72, "zamba2-2.7b": 32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """``jax.jit`` of a reference function with the named arguments static,
    made once per function (one XLA compile per shape, where eager
    evaluation compiles each operation)."""
    return jax.jit(fn, static_argnames=static)


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _flat(tree):
    """A nested reference dict as the port's flat ``a/b`` leaves (numpy)."""
    names, leaves, _ = checkpoint._flatten_with_names(tree)
    return {n: np.asarray(a) for n, a in zip(names, leaves)}


def _randomize(tree, names, seed):
    """``tree`` with the named leaves replaced by random values of their
    shape (around the reference's init value)."""
    rng = np.random.default_rng(seed)
    out = dict(tree)
    for n in names:
        a = np.asarray(tree[n])
        out[n] = jnp.asarray((a + 0.3 * rng.normal(size=a.shape)).astype(
            np.float32))
    return out


def _scan_inputs(t, h=3, K=8, V=6, seed=0, decay=1.0):
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(B, t, h, K)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(B, t, h, V)).astype(np.float32)
    log_w = (-decay * np.exp(rng.normal(size=(B, t, h, K)) - 1)).astype(
        np.float32)
    u = rng.normal(size=(h, K)).astype(np.float32)
    state = rng.normal(size=(B, h, K, V)).astype(np.float32)
    return r, k, v, log_w, u, state


@pytest.mark.parametrize("form", ["bonus", "current", "past"])
@pytest.mark.parametrize("t,chunk,with_state", [(20, 8, True), (32, 16, False),
                                               (5, 64, True)])
def test_chunked_scan_matches_reference(form, t, chunk, with_state):
    """``chunked_linear_attention`` in the u-bonus, in-state and
    strictly-past forms, with and without an initial state, at lengths that
    pad the last chunk (``log w = 0``) and one that does not: the outputs
    and the final state within 1e-5."""
    r, k, v, log_w, u, state = _scan_inputs(t)
    kw = dict(u=u if form == "bonus" else None,
              state=state if with_state else None, chunk=chunk,
              include_current=form == "current")
    wy, ws = _jit(jssm.chunked_linear_attention, "chunk",
                  "include_current")(
        *(jnp.asarray(a) for a in (r, k, v, log_w)),
        **{n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()})
    gy, gs = ssm.chunked_linear_attention(
        *(torch.from_numpy(a) for a in (r, k, v, log_w)),
        **{n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()})
    assert gy.shape == (B, t, 3, 6) and gs.shape == (B, 3, 8, 6)
    assert _err(gy, wy) <= 1e-5
    assert _err(gs, ws) <= 1e-5


@pytest.mark.parametrize("form", ["bonus", "current", "past"])
def test_decode_steps_match_reference_and_the_scan(form):
    """``linear_attention_decode`` step by step against the reference's,
    and the steps against the port's own chunked scan over the same 20
    tokens, within 1e-5."""
    r, k, v, log_w, u, state = _scan_inputs(20, seed=1)
    kw = dict(u=u if form == "bonus" else None,
              include_current=form == "current")
    S, jS = torch.from_numpy(state), jnp.asarray(state)
    ys = []
    for i in range(20):
        step = [a[:, i] for a in (r, k, v, log_w)]
        wy, jS = _jit(jssm.linear_attention_decode, "include_current")(
            *(jnp.asarray(a) for a in step), jS,
            u=None if kw["u"] is None else jnp.asarray(u),
            include_current=kw["include_current"])
        gy, S = ssm.linear_attention_decode(
            *(torch.from_numpy(a) for a in step), S,
            u=None if kw["u"] is None else torch.from_numpy(u),
            include_current=kw["include_current"])
        assert _err(gy, wy) <= 1e-5, i
        ys.append(gy)
    assert _err(S, jS) <= 1e-5
    scan_y, scan_s = ssm.chunked_linear_attention(
        *(torch.from_numpy(a) for a in (r, k, v, log_w)),
        u=kw["u"] if kw["u"] is None else torch.from_numpy(u),
        state=torch.from_numpy(state), chunk=8,
        include_current=kw["include_current"])
    assert _err(torch.stack(ys, 1), scan_y) <= 1e-5
    assert _err(S, scan_s) <= 1e-5


def test_scan_overflow_reproduces_the_references_nans():
    """A chunk whose cumulative log-decay passes -88 overflows ``exp(-L)``
    in f32: the port's scan gives NaN exactly where the reference's does
    (the same factorization), and finite values where it is finite."""
    r, k, v, log_w, u, _ = _scan_inputs(64, seed=2, decay=1.0)
    log_w[:, :, 1] = -2.0  # head 1: L reaches -128 inside the chunk
    wy, _ = _jit(jssm.chunked_linear_attention, "chunk",
                 "include_current")(
        *(jnp.asarray(a) for a in (r, k, v, log_w)), u=jnp.asarray(u))
    gy, _ = ssm.chunked_linear_attention(
        *(torch.from_numpy(a) for a in (r, k, v, log_w)),
        u=torch.from_numpy(u))
    wy, gy = np.asarray(wy), gy.numpy()
    assert np.isnan(wy[:, :, 1]).any() and np.isfinite(wy[:, :, 0]).all()
    assert np.array_equal(np.isnan(gy), np.isnan(wy))
    # the other heads as without the overflow (head 1's finite entries
    # carry factors near e^88, which magnify each rounding)
    assert _err(gy[:, :, [0, 2]], wy[:, :, [0, 2]]) <= 1e-5


def test_softplus_is_logaddexp():
    """``ssm.softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``) past
    ``F.softplus``'s threshold of 20, where that one returns ``x``."""
    x = np.array([-30.0, -5.0, 0.0, 5.0, 19.9, 20.1, 25.0, 60.0], np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(
        jnp.asarray(x))), rtol=1e-7, atol=0)


def _mamba_params(d=32, d_state=8, seed=0):
    p = jssm.init_mamba2(jax.random.key(seed), d, d_state, jnp.float32,
                         expand=2, head_dim=16)
    flat = _flat(p)
    return _randomize(flat, ["A_log", "D", "dt_bias", "conv_b",
                             "norm/scale"], seed + 10)


def _nest(flat):
    out = {}
    for n, a in flat.items():
        node = out
        *path, leaf = n.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(a)
    return out


def _tt(flat):
    return {n: torch.from_numpy(np.asarray(a)) for n, a in flat.items()}


def test_mamba2_fwd_and_decode_match_reference():
    """``mamba2_fwd`` over 20 tokens in chunks of 8 and ``mamba2_decode``
    stepped over the same tokens from a zero cache, each against the
    reference's (outputs, conv buffer and state within 1e-5), and the
    steps against the port's forward."""
    flat = _mamba_params()
    jp, tp = _nest(flat), _tt(flat)
    x = np.random.default_rng(5).normal(size=(B, 20, 32)).astype(np.float32)
    want = _jit(jssm.mamba2_fwd, "d_state", "chunk")(
        jp, jnp.asarray(x), d_state=8, chunk=8)
    got = ssm.mamba2_fwd(tp, torch.from_numpy(x), 8, chunk=8)
    assert _err(got, want) <= 1e-5
    jc = jssm.mamba2_init_cache(jp, B, 8)
    jdecode = jax.jit(jssm.mamba2_decode, static_argnums=3)
    conv = torch.zeros(B, 3, 64)
    state = torch.zeros(B, 4, 8, 16)
    steps = []
    for i in range(20):
        wy, jc = jdecode(jp, jnp.asarray(x[:, i:i + 1]), jc, 8)
        gy, conv, state = ssm.mamba2_decode(
            tp, torch.from_numpy(x[:, i:i + 1]), conv, state, 8)
        assert _err(gy, wy) <= 1e-5, i
        steps.append(gy)
    assert _err(conv, jc["conv"]) <= 1e-5 and _err(state, jc["ssm"]) <= 1e-5
    assert _err(torch.cat(steps, 1), got) <= 1e-5


def _rwkv_params(d=32, h=2, F=48, seed=0):
    tm = _flat(jrwkv.init_rwkv6_timemix(jax.random.key(seed), d, h,
                                        jnp.float32))
    tm = _randomize(tm, ["mix", "u", "w_base", "ln_x/scale"], seed + 20)
    cm = _flat(jrwkv.init_rwkv6_channelmix(jax.random.key(seed + 1), d, F,
                                           jnp.float32))
    cm = _randomize(cm, ["mix"], seed + 21)
    return tm, cm


def test_rwkv_time_and_channel_mix_match_reference():
    """The time-mix and channel-mix forwards over 20 tokens (chunks of 8)
    and their decode steps over the same tokens from zero shift buffers and
    a zero WKV state, against the reference's; the steps against the
    port's forwards; all within 1e-5."""
    tm, cm = _rwkv_params()
    x = np.random.default_rng(6).normal(size=(B, 20, 32)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    want_tm = _jit(jrwkv.rwkv6_timemix_fwd, "n_heads", "chunk")(
        _nest(tm), xj, n_heads=2, chunk=8)
    got_tm = rwkv.timemix_fwd(_tt(tm), xt, 2, chunk=8)
    assert _err(got_tm, want_tm) <= 1e-5
    want_cm = _jit(jrwkv.rwkv6_channelmix_fwd)(_nest(cm), xj)
    got_cm = rwkv.channelmix_fwd(_tt(cm), xt)
    assert _err(got_cm, want_cm) <= 1e-5
    jc = jrwkv.rwkv6_init_cache(_nest(tm), B, 2)
    jshift = jnp.zeros((B, 1, 32), jnp.float32)
    shift_tm, wkv = torch.zeros(B, 1, 32), torch.zeros(B, 2, 16, 16)
    shift_cm = torch.zeros(B, 1, 32)
    out_tm, out_cm = [], []
    jtm = jax.jit(jrwkv.rwkv6_timemix_decode, static_argnums=3)
    jcm = jax.jit(jrwkv.rwkv6_channelmix_decode)
    for i in range(20):
        xi = x[:, i:i + 1]
        wy, jc = jtm(_nest(tm), jnp.asarray(xi), jc, 2)
        gy, shift_tm, wkv = rwkv.timemix_decode(
            _tt(tm), torch.from_numpy(xi), shift_tm, wkv, 2)
        assert _err(gy, wy) <= 1e-5, i
        wz, jshift = jcm(_nest(cm), jnp.asarray(xi), jshift)
        gz, shift_cm = rwkv.channelmix_decode(_tt(cm), torch.from_numpy(xi),
                                              shift_cm)
        assert _err(gz, wz) <= 1e-5, i
        out_tm.append(gy)
        out_cm.append(gz)
    assert _err(wkv, jc["wkv"]) <= 1e-5
    assert _err(torch.cat(out_tm, 1), got_tm) <= 1e-5
    assert _err(torch.cat(out_cm, 1), got_cm) <= 1e-5


def _weights(arch, dtype=None, seed=0, chunk=None):
    """``(jcfg, cfg, jparams, {name: array})`` of the reduced config
    (``dtype`` the compute dtype and ``chunk`` the scan chunk when
    given)."""
    jcfg, cfg = jregistry.get_reduced_config(arch), \
        registry.get_reduced_config(arch)
    if chunk is not None:
        jcfg = dataclasses.replace(jcfg, scan_chunk=chunk)
        cfg = dataclasses.replace(cfg, scan_chunk=chunk)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(
            cfg, dtype=torch.float32 if dtype == jnp.float32
            else torch.bfloat16)
    jparams = japi.init(jax.random.key(seed), jcfg)
    return jcfg, cfg, jparams, _flat(jparams)


def _batch(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, t + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _op_by_op_rwkv_loss(params, jcfg, tokens, labels):
    """The reference's rwkv ``loss_fn`` with its layer scan unrolled, for
    an un-jitted (op-by-op) evaluation."""
    x = params["embed"].astype(jcfg.dtype)[tokens]
    for l in range(jcfg.n_layers):
        bp = jax.tree.map(lambda a: a[l], params["blocks"])
        x = x + jrwkv.rwkv6_timemix_fwd(
            bp["tm"], jlayers.rmsnorm(bp["ln_tm"], x), jcfg.n_heads,
            chunk=jcfg.scan_chunk)
        x = x + jrwkv.rwkv6_channelmix_fwd(
            bp["cm"], jlayers.rmsnorm(bp["ln_cm"], x))
    h = jlayers.rmsnorm(params["final_norm"], x)
    return jlayers.chunked_softmax_xent(
        h, jtr.lm_head_weight(params, jcfg), labels, chunk=jcfg.xent_chunk,
        valid_vocab=jcfg.vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_specs_match_reference(arch):
    """The published and reduced configs field by field, and
    ``param_specs``: the reference's leaf names, shapes and order (the
    published config through ``jax.eval_shape``), with the d_total the
    chip paths print."""
    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "rope_theta",
              "d_state", "ssm_expand", "ssm_head_dim", "shared_attn_every",
              "scan_chunk", "sliding_window", "tie_embeddings", "act",
              "source")
    for jcfg, cfg in ((jregistry.get_config(arch), registry.get_config(arch)),
                      (jregistry.get_reduced_config(arch),
                       registry.get_reduced_config(arch))):
        for f in fields:
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        shapes = jax.eval_shape(lambda: japi.init(jax.random.key(0), jcfg))
        names, leaves, _ = checkpoint._flatten_with_names(shapes)
        assert model_api.param_specs(cfg) == [
            (n, tuple(a.shape)) for n, a in zip(names, leaves)]
    full = registry.get_config(arch)
    cut = dataclasses.replace(full, n_layers=4 if arch == "rwkv6-7b" else 12)
    d_total = sum(math.prod(s) for _, s in model_api.param_specs(cut))
    assert d_total == {"rwkv6-7b": 1_411_567_616,
                       "zamba2-2.7b": 665_436_480}[arch]


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch, chunk=None):
    """The f32 reduced config's batch ``(tokens, labels)`` at ``T[arch]``
    and the reference's ``(loss, leaf names, leaf gradients)`` under
    ``jax.grad`` of its ``model_api.loss`` (jitted once per config for the
    tests that hold them; ``chunk`` the scan chunk when given)."""
    jcfg, cfg, jparams, _ = _weights(arch, chunk=chunk)
    tokens, labels = _batch(cfg, T[arch])
    jl, jg = jax.jit(jax.value_and_grad(lambda p: japi.loss(
        p, jcfg, tokens=jnp.asarray(tokens),
        labels=jnp.asarray(labels))[0]))(jparams)
    names, jleaves, _ = checkpoint._flatten_with_names(jg)
    return (tokens, labels), (jl, names, [np.asarray(a) for a in jleaves])


@pytest.mark.parametrize("arch,dtype,loss_tol,grad_tol", [
    ("rwkv6-7b", jnp.float32, 1e-5, 2e-5),
    ("zamba2-2.7b", jnp.float32, 1e-5, 1e-4),
    ("rwkv6-7b", jnp.bfloat16, 2e-4, 0.15)])
def test_loss_and_grads_match_reference(arch, dtype, loss_tol, grad_tol):
    """The loss and every leaf's gradient under ``jax.grad`` of the
    reference's ``model_api.loss`` (f32, jitted) or of its op-by-op
    evaluation (bf16); zamba2's shared block's gradient is the sum over
    its two uses."""
    jcfg, cfg, jparams, arrays = _weights(arch, dtype)
    if dtype == jnp.float32:
        (tokens, labels), (jl, names, jleaves) = \
            _reference_loss_and_grads(arch)
    else:
        tokens, labels = _batch(cfg, 32)
        jl, jg = jax.value_and_grad(lambda p: _op_by_op_rwkv_loss(
            p, jcfg, jnp.asarray(tokens), jnp.asarray(labels)))(jparams)
        names, jleaves, _ = checkpoint._flatten_with_names(jg)
    params = {k: v.requires_grad_(True) for k, v in
              convert.params_from_numpy(arrays, cfg, "cpu").items()}
    loss, metrics = model_api.loss(params, cfg,
                                   tokens=torch.from_numpy(tokens).long(),
                                   labels=torch.from_numpy(labels).long())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(jl)) <= loss_tol * abs(float(jl))
    assert float(metrics["moe_aux"]) == 0.0
    assert list(params) == names
    for name, g, want in zip(names, grads, jleaves):
        want = np.asarray(want, np.float32)
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= grad_tol, (name, err)


def test_zamba2_chunk_carry_matches_reference():
    """zamba2-2.7b reduced with ``scan_chunk`` 16 on both sides, so its 32
    tokens cross a chunk boundary in every Mamba2 layer and the state one
    chunk hands the next is held against the reference's: the loss within
    1e-5 relative and each leaf's gradient within 1e-4 of its largest
    entry, as at one chunk."""
    _, cfg, _, arrays = _weights("zamba2-2.7b", chunk=16)
    (tokens, labels), (jl, names, jleaves) = _reference_loss_and_grads(
        "zamba2-2.7b", chunk=16)
    params = {k: v.requires_grad_(True) for k, v in
              convert.params_from_numpy(arrays, cfg, "cpu").items()}
    loss, _ = model_api.loss(params, cfg,
                             tokens=torch.from_numpy(tokens).long(),
                             labels=torch.from_numpy(labels).long())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert list(params) == names
    for name, g, want in zip(names, grads, jleaves):
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, (name, err)


def test_zamba2_overflows_at_a_full_chunk_as_the_reference():
    """zamba2-2.7b reduced at the reference's init over 64 tokens, one
    full chunk: the reference's scan overflows f32 (module docstring), and
    the port's too, at the same entries: the loss NaN on both sides and
    the final hidden states NaN exactly where the reference's are (about
    half of them)."""
    jcfg, cfg, jparams, arrays = _weights("zamba2-2.7b")
    tokens, labels = _batch(cfg, 64)
    jh, jl = jax.jit(lambda p, tk, lb: (
        jtr.forward(p, jcfg, tk)[0],
        japi.loss(p, jcfg, tokens=tk, labels=lb)[0]))(
            jparams, jnp.asarray(tokens), jnp.asarray(labels))
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    with torch.no_grad():
        gh = tr.forward(params, cfg, torch.from_numpy(tokens).long())
        gl, _ = model_api.loss(params, cfg,
                               tokens=torch.from_numpy(tokens).long(),
                               labels=torch.from_numpy(labels).long())
    jh, gh = np.asarray(jh), gh.numpy()
    nan = np.isnan(jh)
    assert math.isnan(float(jl)) and math.isnan(float(gl))
    assert 0.2 < nan.mean() < 0.8
    assert np.array_equal(np.isnan(gh), nan)


def test_zamba2_f32_gradients_sit_as_far_from_float64_as_the_references():
    """zamba2-2.7b reduced: the port's f32 gradients are no farther from
    its float64 evaluation than the reference's, leaf by leaf, up to 2x and
    1e-6 of the leaf's largest entry (the grounds of the 1e-4 above)."""
    _, cfg, _, arrays = _weights("zamba2-2.7b")
    (tokens, labels), (_, names, jleaves) = _reference_loss_and_grads(
        "zamba2-2.7b")
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


@pytest.mark.parametrize("arch,tol", [("rwkv6-7b", 2e-5),
                                      ("zamba2-2.7b", 5e-5)])
def test_prefill_and_decode_match_reference(arch, tol):
    """``prefill`` within 1e-5 of the largest logit; 12 decode steps
    against the reference's ``decode_step`` on an f32 cache (``tol`` of
    the largest logit, every cache array within ``tol`` of its largest
    entry); the decode logits against the port's teacher-forced forward
    within 1e-4 in log-probabilities."""
    jcfg, cfg, jparams, arrays = _weights(arch)
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    steps = 12
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, steps)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, tk: japi.prefill(p, jcfg, tokens=tk))(
        jparams, jnp.asarray(toks)))
    with torch.no_grad():
        got = model_api.prefill(params, cfg,
                                tokens=torch.from_numpy(toks).long()).numpy()
    assert _err(got, want) <= 1e-5
    jstep = jax.jit(lambda p, t, c, pos: japi.decode(p, jcfg, t, c, pos))
    jcache = japi.make_cache(jcfg, B, steps, kv_dtype=jnp.float32)
    cache = model_api.make_cache(cfg, B, steps, kv_dtype=torch.float32,
                                 device="cpu")
    assert sorted(cache) == sorted(jcache)
    logits = []
    for i in range(steps):
        wl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                           jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            gl, cache = model_api.decode(
                params, cfg, torch.from_numpy(toks[:, i:i + 1]).long(),
                cache, i)
        assert _err(gl, wl) <= tol, i
        logits.append(gl)
    for name in cache:
        assert cache[name].shape == jcache[name].shape
        assert _err(cache[name], jcache[name]) <= tol, name
    with torch.no_grad():
        h = tr.forward(params, cfg, torch.from_numpy(toks).long())
        lt = torch.matmul(h, tr.lm_head_weight(params, cfg))[..., :cfg.vocab]
    pt = torch.log_softmax(lt, -1)
    pd = torch.log_softmax(torch.stack(logits, 1), -1)
    assert float((pt - pd).abs().max()) <= 1e-4


def test_decode_from_a_reference_cache_mid_sequence():
    """The reference's zamba2 cache after 6 steps (conv, ssm, k, v),
    carried over by ``cache_from_numpy`` bit for bit, continues in the
    port as in the reference for 4 more steps (5e-5 of the largest
    logit)."""
    jcfg, cfg, jparams, arrays = _weights("zamba2-2.7b")
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, 10)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: japi.decode(p, jcfg, t, c, pos))
    jcache = japi.make_cache(jcfg, B, 10)  # bf16 K/V, f32 states
    for i in range(6):
        _, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                          jnp.asarray(i, jnp.int32))
    cache = convert.cache_from_numpy(
        {k: np.asarray(v) for k, v in jcache.items()}, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    for name in cache:
        assert np.array_equal(cache[name].float().numpy(),
                              np.asarray(jcache[name], np.float32)), name
    for i in range(6, 10):
        wl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                           jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            gl, cache = model_api.decode(
                params, cfg, torch.from_numpy(toks[:, i:i + 1]).long(),
                cache, i)
        assert _err(gl, wl) <= 5e-5, i
    with pytest.raises(ValueError):
        convert.cache_from_numpy({"conv": np.zeros(3, np.float32),
                                  "ssm": np.zeros(3, np.float32)},
                                 device="cpu")
