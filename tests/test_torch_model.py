"""The port's dense model against the reference's, with the reference's
weights carried over by ``repro_torch.convert``.

On the reduced gemma2-2b config (f32 compute) at sequence length 96, longer
than the local layers' window of 64, the loss and every per-leaf gradient
agree with ``model_api.loss`` under ``jax.grad`` to 1e-5 relative (to the
leaf's largest entry): the two frameworks sum the products in different
orders, nothing else differs.
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
from repro.configs import registry as jregistry
from repro.dist import model_api as japi
from repro_torch import convert
from repro_torch.configs import gemma2_2b, registry
from repro_torch.dist import comm_ws, model_api
from repro_torch.models import layers

T, B = 96, 2


def _reference_params(cfg, seed=0):
    params = japi.init(jax.random.key(seed), cfg)
    names, leaves, _ = checkpoint._flatten_with_names(params)
    return params, {n: np.asarray(a) for n, a in zip(names, leaves)}


# the full-width rows the card's training paths pack: (arch, layers) ->
# d_total f32 per client row
FULL_WIDTH_ROWS = {("gemma2-2b", 2): 745_558_272,
                   ("stablelm-3b", 6): 733_427_200,
                   ("internvl2-26b", 1): 1_566_590_976}


@pytest.mark.parametrize("arch,layers", [
    ("gemma2-2b", 2), ("gemma2-2b", 26), ("gemma2-9b", 2), ("gemma2-9b", 42),
    ("stablelm-3b", 2), ("stablelm-3b", 6), ("stablelm-3b", 32),
    ("deepseek-coder-33b", 2), ("deepseek-coder-33b", 62),
    ("internvl2-26b", 1), ("internvl2-26b", 2), ("internvl2-26b", 48)])
def test_leaf_names_order_and_shapes_match_reference(arch, layers):
    """Every dense architecture at its published widths, cut to 2 layers
    (and to the card's training depths) and at full depth: the names
    (q/k/v biases, ``lm_head``, ``prefix_proj`` included), order and
    shapes of ``jax.eval_shape`` of the reference's init."""
    jcfg = dataclasses.replace(jregistry.get_config(arch), n_layers=layers)
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=layers)
    struct = jax.eval_shape(lambda: japi.init(jax.random.key(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(struct)
    want = [("/".join(str(e.key) for e in path), tuple(a.shape))
            for path, a in flat]
    assert model_api.param_specs(cfg) == want
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    if (arch, layers) in FULL_WIDTH_ROWS:  # one client row on the card
        assert spec.d_total == FULL_WIDTH_ROWS[arch, layers]
    assert spec.d_total == sum(int(np.prod(s)) for _, s in want)


def test_reduced_config_matches_reference_fields():
    jcfg, cfg = jgemma.REDUCED, registry.get_reduced_config("gemma2-2b")
    for f in dataclasses.fields(cfg):
        if f.name in ("dtype", "param_dtype"):
            continue
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.layer_windows() == list(np.asarray(jcfg.layer_windows()))
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
    assert cfg.param_dtype == torch.float32
    assert jcfg.param_dtype == jnp.float32


def test_loss_and_grads_match_reference():
    jcfg, cfg = jgemma.REDUCED, gemma2_2b.REDUCED
    assert T > cfg.sliding_window
    jparams, arrays = _reference_params(jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)

    def jloss(p):
        return japi.loss(p, jcfg, tokens=jnp.asarray(tokens),
                         labels=jnp.asarray(labels))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    names, jleaves, _ = checkpoint._flatten_with_names(jg)

    params = {k: v.requires_grad_(True) for k, v in
              convert.params_from_numpy(arrays, cfg, "cpu").items()}
    loss, _ = model_api.loss(params, cfg,
                             tokens=torch.from_numpy(tokens).long(),
                             labels=torch.from_numpy(labels).long())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert list(params) == names
    for name, g, want in zip(names, grads, jleaves):
        want = np.asarray(want)
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (name, err)


def test_float64_layers_stay_float64():
    """A float64 compute dtype is not rounded through f32: rmsnorm and RoPE
    on float64 inputs match a float64 numpy evaluation to 1e-13 (an f32
    pass would show at ~1e-7)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16))
    scale = rng.normal(size=(16,))
    got = layers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x))
    want = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6) * (1 + scale)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-13
    got = layers.apply_rope(torch.from_numpy(x), torch.arange(5), 10000.0)
    angles = np.arange(5)[:, None] / 10000.0 ** (np.arange(0, 16, 2) / 16)
    cos, sin = np.cos(angles)[:, None], np.sin(angles)[:, None]
    x1, x2 = x[..., :8], x[..., 8:]
    want = np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-13


def test_float64_model_agrees_with_f32_model():
    """The reduced model with a float64 compute dtype (the float64
    evaluation ``reduced_round_diag.py`` holds both sides of a round
    against) against the f32 model on the same weights, past the local
    window: the loss within 1e-6 relative, every gradient within 5e-5 of
    its leaf's largest entry (f32 rounding; 8.7e-8 and 9.3e-6 measured)."""
    cfg = gemma2_2b.REDUCED
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    params = model_api.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, T + 1)))
    out = {}
    for c, cast in ((cfg, torch.float32), (cfg64, torch.float64)):
        p = {k: v.to(cast).requires_grad_(True) for k, v in params.items()}
        loss, _ = model_api.loss(p, c, tokens=toks[:, :-1],
                                 labels=toks[:, 1:])
        out[cast] = loss, torch.autograd.grad(loss, list(p.values()))
    (l32, g32), (l64, g64) = out[torch.float32], out[torch.float64]
    assert l64.dtype == torch.float64
    assert abs(l32.item() - l64.item()) <= 1e-6 * abs(l64.item())
    for name, a, b in zip(params, g32, g64):
        assert b.dtype == torch.float64, name
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= 5e-5, (name, err)


def test_read_checkpoint_carries_reference_weights(tmp_path):
    cfg = gemma2_2b.REDUCED
    jparams, arrays = _reference_params(jgemma.REDUCED, seed=3)
    checkpoint.save(str(tmp_path / "f32"), jparams, step=1)
    got = convert.read_checkpoint(str(tmp_path / "f32"))
    params = convert.params_from_numpy(got, cfg, "cpu")
    for name, a in arrays.items():
        np.testing.assert_array_equal(params[name].numpy(), a)
    # bf16 leaves are stored as raw bits and widen exactly
    checkpoint.save(str(tmp_path / "bf16"),
                    jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams))
    got = convert.read_checkpoint(str(tmp_path / "bf16"))
    for name, a in arrays.items():
        np.testing.assert_array_equal(
            got[name], a.astype(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(ValueError):
        convert.params_from_numpy({"embed": arrays["embed"]}, cfg, "cpu")
