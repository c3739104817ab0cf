"""The port's optimizers (``repro_torch.optim.optimizers``) against the
reference's (``repro.optim.optimizers``) on the same numpy inputs, 5 steps
each.

The reference runs un-jitted: each jnp operation then rounds on its own,
as the port's torch operations do (under ``jax.jit`` XLA may fuse AdamW's
``b1 m + (1 - b1) g`` into a multiply-add).  ``sgd``, ``momentum`` and
``adamw`` (with and without weight decay) agree bitwise, parameters and
moments, over a dict of leaves and over a single tensor; AdamW's bias
corrections come from numpy's f32 ``pow`` on scalars, which rounds as
XLA's does on every count to 3000 (torch's f32 ``pow`` does not, at ``b2 =
0.999``), and the square root on the CPU from f64 rounded once (torch's
f32 ``sqrt`` there is not correctly rounded).
``global_norm`` sums in another order than jnp's reductions: within 1e-6
relative; ``clip_by_global_norm`` then within 2e-7 of the largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers

SHAPES = {"b": (3, 17), "a": (40,), "w": (5, 4, 3)}
STEPS = 5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * (0.1 + t)
              for k, s in SHAPES.items()} for t in range(STEPS)]
    return params, grads


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _same(got, want):
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().tobytes() == w.tobytes(), k


@pytest.mark.parametrize("name, kw", [
    ("sgd", {"lr": 0.05}),
    ("momentum", {"lr": 0.05, "beta": 0.9}),
    ("adamw", {"lr": 0.05}),
    ("adamw", {"lr": 0.01, "b1": 0.8, "b2": 0.99, "eps": 1e-6,
               "weight_decay": 0.1}),
])
def test_optimizer_matches_reference_bitwise(name, kw):
    params, grads = _inputs(3)
    jo = getattr(jopt, name)(**kw)
    to = getattr(optimizers, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update(_torch(g), ts, tp)
    _same(tp, jp)
    if name == "momentum":
        _same(ts, js)
    if name == "adamw":
        _same(ts.mu, js.mu)
        _same(ts.nu, js.nu)
        assert ts.count == int(js.count) == STEPS


def test_adamw_on_one_tensor_and_in_chunks_matches_reference(monkeypatch):
    """A single tensor is one leaf; a leaf longer than ``CHUNK`` is updated
    chunk by chunk with the same values."""
    monkeypatch.setattr(optimizers, "CHUNK", 7)
    rng = np.random.default_rng(4)
    p = rng.normal(size=(6, 9)).astype(np.float32)
    jo, to = jopt.adamw(0.03, weight_decay=0.01), \
        optimizers.adamw(0.03, weight_decay=0.01)
    jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
    js, ts = jo.init(jp), to.init(tp)
    for t in range(STEPS):
        g = rng.normal(size=p.shape).astype(np.float32)
        jp, js = jo.update(jnp.asarray(g), js, jp)
        tp, ts = to.update(torch.from_numpy(g), ts, tp)
    assert tp.numpy().tobytes() == np.asarray(jp).tobytes()
    assert ts.nu.numpy().tobytes() == np.asarray(js.nu).tobytes()


def test_adamw_bias_scales_match_the_reference_at_every_count():
    counts = jnp.arange(1, 3001, dtype=jnp.int32)
    for b in (0.9, 0.999):
        want = np.asarray(1.0 / (1 - b ** counts.astype(jnp.float32)))
        got = np.array([optimizers.adamw_bias_scales(int(c), b, b)[0]
                        for c in range(1, 3001)], np.float32)
        assert got.tobytes() == want.tobytes(), b


def test_global_norm_and_clip_match_reference():
    params, _ = _inputs(5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = _torch(params)
    want = float(jopt.global_norm(jp))
    got = float(optimizers.global_norm(tp))
    assert abs(got - want) <= 1e-6 * want
    for max_norm in (0.5 * want, 2.0 * want):
        jc = jopt.clip_by_global_norm(jp, max_norm)
        tc = optimizers.clip_by_global_norm(tp, max_norm)
        top = max(float(np.abs(v).max()) for v in params.values())
        for k in params:
            err = np.abs(tc[k].numpy() - np.asarray(jc[k])).max()
            assert err <= 2e-7 * top, (k, err)
    # below the cap every leaf is returned unchanged
    tc = optimizers.clip_by_global_norm(tp, 2.0 * want)
    _same(tc, {k: np.asarray(v) for k, v in params.items()})

