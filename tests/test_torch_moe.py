"""The MoE family in the port against the reference (``repro.models.moe``
and the qwen2-moe-a2.7b / qwen3-moe-30b-a3b reduced configs).

Inputs are numpy-seeded and the reference's weights come across with
``repro_torch.convert``.  Tolerances: the router's top indices equal and
its probabilities, load-balance and z terms within 1e-6 relative (f32);
the MoE block in f32 within 1e-5 of its largest output; the reduced
configs' loss within 1e-5 relative and each leaf's gradient within 2e-5
of its largest entry (measured 1.4e-5 on qwen2-moe's embedding at t = 72:
both frameworks' f32 gradients lie 0.5-1.5e-5 from a float64 evaluation,
and the port's are held to at most twice the reference's distance plus
1e-6); prefill within 1e-5 and decode within 2e-5 of the largest logit
(``tests/test_torch_family.py``'s), decode against the port's own
teacher-forced forward within 1e-4 in log-probabilities.

Routing is discontinuous, so the parity tests run in f32, where the
reduced configs are: a one-ulp difference in a router logit can move a
token to another expert.  The bf16 expert math is held with the
reference's own ``top_idx`` and ``top_p`` injected into both sides.
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
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist import model_api
from repro_torch.models import moe
from repro_torch.models import transformer as tr

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
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


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """``jax.jit`` of a reference function with the named arguments static,
    made once per function (one XLA compile per shape, where eager
    evaluation compiles each operation)."""
    return jax.jit(fn, static_argnames=static)


def _weights(arch, seed=0):
    """``(jcfg, cfg, jparams, {name: array})`` of the reduced config."""
    jcfg = jregistry.get_reduced_config(arch)
    cfg = registry.get_reduced_config(arch)
    jparams = japi.init(jax.random.key(seed), jcfg)
    names, leaves, _ = checkpoint._flatten_with_names(jparams)
    arrays = {n: np.asarray(a) for n, a in zip(names, leaves)}
    return jcfg, cfg, jparams, arrays


def _moe_params(d=64, E=8, F=32, S=48, seed=0):
    """One MoE layer's leaves (shared experts when ``S``), numpy f32, with
    a random shared gate (the reference initialises it to zero)."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, E)) / math.sqrt(d),
         "w_gate": rng.normal(size=(E, d, F)) / math.sqrt(d),
         "w_up": rng.normal(size=(E, d, F)) / math.sqrt(d),
         "w_down": rng.normal(size=(E, F, d)) / math.sqrt(F)}
    if S:
        p.update({"shared/w_gate": rng.normal(size=(d, S)) / math.sqrt(d),
                  "shared/w_up": rng.normal(size=(d, S)) / math.sqrt(d),
                  "shared/w_down": rng.normal(size=(S, d)) / math.sqrt(S),
                  "shared_gate": rng.normal(size=(d, 1))})
    return {k: v.astype(np.float32) for k, v in p.items()}


def _nested(p):
    """The reference's nested layout of one layer's flat leaves."""
    out = {k: jnp.asarray(v) for k, v in p.items() if "/" not in k}
    if "shared_gate" in p:
        out["shared"] = {k.split("/")[1]: jnp.asarray(v)
                         for k, v in p.items() if k.startswith("shared/")}
    return out


def _t(p, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}


def test_top_k_ties_go_to_the_lower_index():
    """Constructed ties, every one of them a tie ``torch.topk`` may break
    either way: the port's order is ``jax.lax.top_k``'s, values and
    indices, on rows with 2, 3 and all-equal maxima and ties across the
    k-th place."""
    rows = np.array([
        [0.1, 0.3, 0.3, 0.2, 0.1, 0.0],
        [0.2, 0.2, 0.2, 0.2, 0.1, 0.1],
        [0.25, 0.25, 0.25, 0.25, 0.25, 0.25],
        [0.0, 0.5, 0.1, 0.5, 0.1, 0.5],
        [0.3, 0.1, 0.1, 0.1, 0.3, 0.1],
    ], np.float32)
    rng = np.random.default_rng(1)
    # a large batch of quarter-step values: many exact ties at every rank
    big = (np.round(rng.normal(size=(4096, 60)) * 4) / 4).astype(np.float32)
    for probs, k in ((rows, 2), (rows, 3), (rows, 4),
                     (big, 4), (big, 8)):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi)), (probs.shape, k)
        assert np.array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("renormalize", [True, False])
def test_route_matches_reference(renormalize):
    """``route`` on random inputs, and on a router whose columns repeat
    (exactly tied probabilities for every token): equal indices, the
    renormalized or raw probabilities and both aux terms within 1e-6."""
    p = _moe_params(S=0)
    tied = dict(p, router=np.repeat(p["router"][:, :4], 2, axis=1))
    x = np.random.default_rng(2).normal(size=(3, 20, 64)).astype(np.float32)
    for params in (p, tied):
        wi, wp, waux = _jit(jmoe.route, "top_k", "renormalize")(
            _nested(params), jnp.asarray(x), 3, renormalize)
        gi, gp, gaux = moe.route(_t(params), torch.from_numpy(x), 3,
                                 renormalize)
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6,
                                   atol=1e-7)
        for key in ("load_balance", "router_z"):
            assert abs(float(gaux[key]) - float(waux[key])) <= 1e-6 * abs(
                float(waux[key])), key


@pytest.mark.parametrize("dispatch", ["dense", "gather", "auto"])
@pytest.mark.parametrize("shared", [48, 0])
def test_moe_fwd_matches_reference(dispatch, shared):
    """``moe_fwd`` in f32 against the reference's with the same dispatch
    (``auto`` takes the gather at 2 tokens x top-3 <= 8 experts), and the
    port's dense and gather dispatches against each other, within 1e-5 of
    the largest output."""
    p = _moe_params(S=shared)
    for shape in ((2, 1, 64), (2, 9, 64)):
        x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
        want, waux = _jit(jmoe.moe_fwd, "top_k", "act", "renormalize",
                          "dispatch")(_nested(p), jnp.asarray(x), 3, "silu",
                                      False, dispatch=dispatch)
        got, gaux = moe.moe_fwd(_t(p), torch.from_numpy(x), 3, "silu", False,
                                dispatch=dispatch)
        want = np.asarray(want)
        top = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-5 * top, shape
        other = "gather" if moe.resolve_dispatch(
            dispatch, shape[0] * shape[1], 3, 8) == "dense" else "dense"
        alt, _ = moe.moe_fwd(_t(p), torch.from_numpy(x), 3, "silu", False,
                             dispatch=other)
        assert np.abs(alt.numpy() - want).max() <= 1e-5 * top, other
        assert abs(float(gaux["load_balance"])
                   - float(waux["load_balance"])) <= 1e-6


def test_auto_dispatch_rule_and_its_override(monkeypatch):
    """``auto`` gathers iff tokens x top_k <= experts (the reference's
    rule), ``REPRO_MOE_DISPATCH`` forces either, and an unknown dispatch
    is refused."""
    monkeypatch.delenv("REPRO_MOE_DISPATCH", raising=False)
    assert moe.resolve_dispatch("auto", 8, 4, 60) == "gather"  # 32 <= 60
    assert moe.resolve_dispatch("auto", 16, 4, 60) == "dense"  # 64 > 60
    assert moe.resolve_dispatch("auto", 256, 8, 128) == "dense"
    assert moe.resolve_dispatch("gather", 256, 8, 128) == "gather"
    monkeypatch.setenv("REPRO_MOE_DISPATCH", "gather")
    assert moe.resolve_dispatch("auto", 256, 8, 128) == "gather"
    monkeypatch.setenv("REPRO_MOE_DISPATCH", "dense")
    assert moe.resolve_dispatch("auto", 1, 4, 60) == "dense"
    with pytest.raises(ValueError):
        moe.resolve_dispatch("sparse", 1, 4, 60)


@pytest.mark.parametrize("dispatch", ["dense", "gather"])
def test_bf16_experts_with_the_references_routing(dispatch, monkeypatch):
    """The bf16 expert math, with the reference's ``top_idx`` and
    ``top_p`` (from its own bf16 router) injected into both sides: the
    reference's ``moe_fwd`` (its ``route`` patched to return them, evaluated
    op by op) against the port's experts and shared expert, within one
    bf16 ulp of the largest output (the f32 sums over experts and hidden
    units run in other orders before the rounding)."""
    p = _moe_params()
    x32 = np.random.default_rng(4).normal(size=(2, 9, 64)).astype(np.float32)
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    idx, prob, aux = jmoe.route(_nested(p), xb, 3, False)
    monkeypatch.setattr(jmoe, "route", lambda *a, **k: (idx, prob, aux))
    want, _ = jmoe.moe_fwd(_nested(p), xb, 3, "silu", False,
                           dispatch=dispatch)
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    params = _t(p)
    got = moe.experts(params, xt, torch.from_numpy(np.asarray(idx)).long(),
                      torch.from_numpy(np.asarray(prob)), "silu", dispatch)
    gate = moe.layers.sigmoid(moe.layers.widen(moe.layers.matmul(
        xt, params["shared_gate"]))).to(xt.dtype)
    got = got + gate * moe.layers.mlp(xt, params["shared/w_gate"],
                                      params["shared/w_up"],
                                      params["shared/w_down"], "silu")
    got = got.float().numpy()
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp
    assert (got == want).mean() > 0.9


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_specs_match_reference(arch):
    """The published and reduced configs field by field, and
    ``param_specs``: the reference's ``tree_flatten_with_path`` names,
    shapes and order (the published config through ``jax.eval_shape``,
    with the d_total the chip paths print)."""
    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "rope_theta",
              "qkv_bias", "num_experts", "top_k", "moe_d_ff", "shared_d_ff",
              "renormalize", "tie_embeddings", "act", "source")
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
    one = dataclasses.replace(full, n_layers=2 if arch.startswith(
        "qwen2") else 1)
    d_total = sum(math.prod(s) for _, s in model_api.param_specs(one))
    assert d_total == {"qwen2-moe-a2.7b": 1_763_452_928,
                       "qwen3-moe-30b-a3b": 1_245_452_288}[arch]
    assert arch in registry.list_archs()


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch):
    """The reduced config's batch ``(tokens, labels)`` and the reference's
    ``(loss, metrics, leaf names, leaf gradients)`` under ``jax.grad`` of
    its ``model_api.loss`` (f32, jitted once per config for the tests
    that hold them)."""
    jcfg, cfg, jparams, _ = _weights(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(B, T + 1)).astype(np.int32)
    tk, lb = toks[:, :-1], toks[:, 1:]
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, tokens=jnp.asarray(tk),
                            labels=jnp.asarray(lb)), has_aux=True))(jparams)
    names, jleaves, _ = checkpoint._flatten_with_names(jg)
    return (tk, lb), (jl, jm, names, [np.asarray(a) for a in jleaves])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The total loss (cross-entropy + 0.01 load balance) and its metrics,
    and every leaf's gradient under ``jax.grad`` of the reference's
    ``model_api.loss`` (f32, jitted)."""
    _, cfg, _, arrays = _weights(arch)
    (tk, lb), (jl, jm, names, jleaves) = _reference_loss_and_grads(arch)
    params = {k: v.requires_grad_(True) for k, v in
              convert.params_from_numpy(arrays, cfg, "cpu").items()}
    loss, metrics = model_api.loss(params, cfg,
                                   tokens=torch.from_numpy(tk).long(),
                                   labels=torch.from_numpy(lb).long())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for key in ("xent", "moe_aux"):
        assert abs(float(metrics[key]) - float(jm[key])) <= 1e-5 * abs(
            float(jm[key])), key
    assert float(metrics["moe_aux"]) > 1.0  # the term reaches the loss
    assert abs(loss.item() - float(metrics["xent"])
               - 0.01 * float(metrics["moe_aux"])) <= 1e-6
    assert list(params) == names
    for name, g, want in zip(names, grads, jleaves):
        want = np.asarray(want, np.float32)
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-5, (name, err)


def test_f32_gradients_sit_as_far_from_float64_as_the_references():
    """qwen2-moe-a2.7b reduced: the port's f32 gradients are no farther
    from its float64 evaluation than the reference's f32 gradients, leaf by
    leaf, up to 2x and 1e-6 of the leaf's largest entry (the grounds of
    the 2e-5 above)."""
    _, cfg, _, arrays = _weights("qwen2-moe-a2.7b")
    (tk, lb), (_, _, names, jleaves) = _reference_loss_and_grads(
        "qwen2-moe-a2.7b")
    got = {}
    for dt in (torch.float32, torch.float64):
        c = dataclasses.replace(cfg, dtype=dt)
        p = {n: torch.from_numpy(arrays[n]).to(dt).requires_grad_(True)
             for n in names}
        loss, _ = model_api.loss(p, c, tokens=torch.from_numpy(tk).long(),
                                 labels=torch.from_numpy(lb).long())
        got[dt] = torch.autograd.grad(loss, list(p.values()))
    for name, w, g32, g64 in zip(names, jleaves, got[torch.float32],
                                 got[torch.float64]):
        g64 = g64.numpy()
        top = np.abs(g64).max()
        ref_err = np.abs(np.asarray(w, np.float64) - g64).max() / top
        port_err = np.abs(g32.double().numpy() - g64).max() / top
        assert port_err <= 2 * ref_err + 1e-6, (name, port_err, ref_err)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` within 1e-5 and 12 decode steps (each a gather
    dispatch: 2 tokens x top-2 <= 4 experts) on an f32 cache within 2e-5
    of the largest logit, the cache within 1e-5; the decode logits against
    the port's teacher-forced forward within 1e-4 in log-probabilities."""
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
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    jstep = jax.jit(lambda p, t, c, pos: japi.decode(p, jcfg, t, c, pos))
    jcache = japi.make_cache(jcfg, B, steps, kv_dtype=jnp.float32)
    cache = model_api.make_cache(cfg, B, steps, kv_dtype=torch.float32,
                                 device="cpu")
    logits = []
    for i in range(steps):
        wl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                           jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            gl, cache = model_api.decode(
                params, cfg, torch.from_numpy(toks[:, i:i + 1]).long(),
                cache, i)
        wl = np.asarray(wl)
        assert np.abs(gl.numpy() - wl).max() <= 2e-5 * np.abs(wl).max(), i
        logits.append(gl)
    for name in ("k", "v"):
        a, b = cache[name].numpy(), np.asarray(jcache[name])
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    with torch.no_grad():
        h = tr.forward(params, cfg, torch.from_numpy(toks).long())
        lt = torch.matmul(h, tr.lm_head_weight(params, cfg))[..., :cfg.vocab]
    pt = torch.log_softmax(lt, -1)
    pd = torch.log_softmax(torch.stack(logits, 1), -1)
    assert float((pt - pd).abs().max()) <= 1e-4


def test_unknown_dispatch_env_value_is_ignored(monkeypatch):
    """An unknown ``REPRO_MOE_DISPATCH`` value leaves ``auto`` to its rule,
    as in the reference (only "dense" and "gather" force)."""
    monkeypatch.setenv("REPRO_MOE_DISPATCH", "sparse")
    assert moe.resolve_dispatch("auto", 8, 4, 60) == "gather"
    assert moe.resolve_dispatch("auto", 64, 4, 60) == "dense"
