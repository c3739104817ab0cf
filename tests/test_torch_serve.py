"""The port's serving side against the reference's, on the CPU.

Decode attention: the port's plain version (``kernels.ref.decode_attention``,
which the CUDA kernel's wrapper runs for CPU tensors) against the Pallas
kernel in interpret mode and ``decode_attention_ref`` over
``tests/test_kernels.py``'s shapes, windows and softcaps, within 2e-5 in f32
(the reference's own tolerance between the two) and one bf16 ulp in bf16.

The model: ``decode_step`` on the reduced gemma2-2b (window 64) with the
reference's weights, stepped past position 64, against
``repro.dist.model_api.decode`` (the logits within 2e-5 of the largest
logit, ~2 here: the frameworks sum the products in other orders, and 72
steps measured 7e-6), run through on an f32 cache and step by step from
the reference's bf16 cache, carried over by ``cache_from_numpy``; the
kernel's adapter against the reference's jnp path; decode stepping against
the port's own teacher-forced forward; sampling and generation with the
reference's Gumbel draws injected; the CLI on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro import serve_utils as jserve
from repro.configs import gemma2_2b as jgemma
from repro.dist import model_api as japi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert, serve_utils
from repro_torch.configs import gemma2_2b
from repro_torch.dist import model_api
from repro_torch.kernels import decode_attn, ref
from repro_torch.models import transformer as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# positions stepped: past the reduced config's local window of 64
STEPS = 72


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down by 10-100x when
    they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b, h, kvh, hd, S, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, hd)).astype(dtype),
            rng.normal(size=(b, S, kvh, hd)).astype(dtype),
            rng.normal(size=(b, S, kvh, hd)).astype(dtype))


def _port_attn(q, k, v, pos, **kw):
    """The wrapper on CPU tensors (its plain version), checked to be
    ``ref.decode_attention`` itself."""
    qt, kt, vt = (torch.from_numpy(np.asarray(a, np.float32)) for a in
                  (q, k, v))
    out = decode_attn.decode_attention(qt, kt, vt, pos, **kw)
    assert torch.equal(out, ref.decode_attention(qt, kt, vt, pos, **kw))
    return out.numpy()


@pytest.mark.parametrize("b,h,kvh,hd,S,bs", [
    (2, 8, 4, 64, 1024, 256),
    (1, 4, 1, 128, 2048, 512),
    (3, 6, 6, 32, 512, 128),  # MHA
    (1, 8, 1, 64, 1024, 1024),  # a single KV block
])
def test_decode_attention_matches_reference_sweep(b, h, kvh, hd, S, bs):
    q, k, v = _qkv(b, h, kvh, hd, S, b * h + S)
    for pos in (0, S // 3, S - 1):
        got = _port_attn(q, k, v, pos)
        pal = np.asarray(jops.decode_attention(
            q, k, v, jnp.asarray(pos, jnp.int32), block_s=bs))
        want = np.asarray(jref.decode_attention_ref(
            q, k, v, jnp.asarray(pos, jnp.int32)))
        assert np.abs(got - pal).max() < 2e-5, pos
        assert np.abs(got - want).max() < 2e-5, pos


@pytest.mark.parametrize("window", [16, 128])
@pytest.mark.parametrize("softcap", [None, 30.0, 50.0])
def test_decode_attention_window_softcap_matches_reference(window, softcap):
    q, k, v = _qkv(2, 4, 2, 64, 512, 0)
    pos = 300
    got = _port_attn(q, k, v, pos, window=window, softcap=softcap)
    pal = np.asarray(jops.decode_attention(
        q, k, v, jnp.asarray(pos, jnp.int32), window=window,
        softcap=softcap, block_s=128))
    want = np.asarray(jref.decode_attention_ref(
        q, k, v, jnp.asarray(pos, jnp.int32), window=window,
        softcap=softcap))
    assert np.abs(got - pal).max() < 2e-5
    assert np.abs(got - want).max() < 2e-5


def _bf16_ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -10)
    return float((np.abs(a - b) / np.exp2(np.floor(np.log2(mag)) - 7)).max())


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_decode_attention_bf16_within_one_ulp(softcap):
    q, k, v = (a.astype(ml_dtypes.bfloat16)
               for a in _qkv(1, 4, 2, 64, 512, 3))
    pos = 511
    tq, tk, tv = (torch.from_numpy(a.view(np.uint16).astype(np.int32))
                  .to(torch.int16).view(torch.bfloat16) for a in (q, k, v))
    got = decode_attn.decode_attention(tq, tk, tv, pos, softcap=softcap)
    assert got.dtype == torch.bfloat16
    pal = jops.decode_attention(q, k, v, jnp.asarray(pos, jnp.int32),
                                softcap=softcap, block_s=128)
    want = jref.decode_attention_ref(q, k, v, jnp.asarray(pos, jnp.int32),
                                     softcap=softcap)
    got = got.float().numpy()
    assert _bf16_ulps(got, np.asarray(want, np.float32)) <= 1.0
    assert _bf16_ulps(got, np.asarray(pal, np.float32)) <= 1.0


def test_split_plan_covers_the_visible_keys():
    for b, kvh, n in ((8, 4, 30001), (8, 4, 4096), (8, 4, 1), (1, 1, 513),
                      (4, 4, 4608), (2, 2, 64)):
        n_splits, split_len = decode_attn.split_plan(b, kvh, n)
        assert n_splits * split_len >= n > (n_splits - 1) * split_len
        # the bf16 kernel's plan: whole 16-key tiles, every block at once
        n_splits, split_len = decode_attn.split_plan(b, kvh, n, tiled=True)
        assert n_splits * split_len >= n > (n_splits - 1) * split_len
        assert split_len % decode_attn.TILE == 0
        assert b * kvh * n_splits <= max(b * kvh, decode_attn.TILED_BLOCKS)
    # a global window far past the cache leaves every key visible
    assert decode_attn.visible_keys(30000, tr.GLOBAL_WINDOW) == (0, 30001)
    assert decode_attn.visible_keys(30000, 4096) == (25905, 4096)
    assert decode_attn.visible_keys(10, 4096) == (0, 11)


# ---- the model's decode path ---------------------------------------------


@pytest.fixture(scope="module")
def reduced():
    """The reduced config's reference weights in both frameworks and a
    jitted reference decode step."""
    jcfg, cfg = jgemma.REDUCED, gemma2_2b.REDUCED
    jparams = japi.init(jax.random.key(0), jcfg)
    names, leaves, _ = checkpoint._flatten_with_names(jparams)
    params = convert.params_from_numpy(
        {n: np.asarray(a) for n, a in zip(names, leaves)}, cfg, "cpu")
    jstep = jax.jit(lambda p, t, c, pos, attend=None: japi.decode(
        p, jcfg, t, c, pos, attend_fn=attend), static_argnames="attend")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, size=(2, STEPS)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jstep=jstep, toks=toks)


def _logits_err(got, want):
    """max over steps of max|got - want| / max|want|."""
    return max(float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(got, want))


def _cache_np(c):
    return {k: np.asarray(v) for k, v in c.items()}


def _ref_decode_run(r, kv_dtype, steps=STEPS, snap=None):
    cache = japi.make_cache(r["jcfg"], 2, STEPS + 4, kv_dtype=kv_dtype)
    logits, snapshot = [], None
    for i in range(steps):
        if i == snap:
            snapshot = _cache_np(cache)
        lg, cache = r["jstep"](r["jparams"], r["toks"][:, i:i + 1], cache,
                               jnp.asarray(i, jnp.int32))
        logits.append(np.asarray(lg))
    return logits, cache, snapshot


def _port_decode_run(r, kv_dtype, start=0, cache=None, attend_fn=None):
    if cache is None:
        cache = model_api.make_cache(r["cfg"], 2, STEPS + 4,
                                     kv_dtype=kv_dtype, device="cpu")
    toks = torch.from_numpy(r["toks"]).long()
    logits = []
    with torch.no_grad():
        for i in range(start, STEPS):
            lg, cache = model_api.decode(r["params"], r["cfg"],
                                         toks[:, i:i + 1], cache, i,
                                         attend_fn=attend_fn)
            logits.append(lg.numpy())
    return logits, cache


def test_decode_step_matches_reference_past_the_window(reduced):
    """An f32 cache, 72 steps run through: logits within 2e-5 and the cache
    within 1e-5 of their largest entries."""
    r = reduced
    assert STEPS > r["cfg"].sliding_window
    want, jcache, _ = _ref_decode_run(r, jnp.float32)
    got, cache = _port_decode_run(r, torch.float32)
    err = _logits_err(got, want)
    assert err < 2e-5, err
    for name in ("k", "v"):
        a, b = cache[name].numpy(), np.asarray(jcache[name])
        assert np.abs(a - b).max() < 1e-5 * np.abs(b).max(), name


@pytest.mark.parametrize("pos", [0, 31, 63, 64, 65, 71])
def test_decode_step_on_a_bf16_cache_matches_reference(reduced, pos):
    """One step from the reference's own bf16 cache (the CLI's), on both
    sides of the window: logits within 2e-5 of the largest, and the rows
    written at ``pos`` within one bf16 ulp (an f32 key one bit apart may
    round to the neighbouring bf16 value; run through many steps, such
    flips compound, so each step starts from the same cache)."""
    r = reduced
    _, _, snap = _ref_decode_run(r, jnp.bfloat16, steps=pos + 1, snap=pos)
    want, jcache = r["jstep"](r["jparams"], r["toks"][:, pos:pos + 1],
                              {k: jnp.asarray(v) for k, v in snap.items()},
                              jnp.asarray(pos, jnp.int32))
    cache = convert.cache_from_numpy(snap, device="cpu")
    with torch.no_grad():
        got, cache = model_api.decode(
            r["params"], r["cfg"],
            torch.from_numpy(r["toks"][:, pos:pos + 1]).long(), cache, pos)
    err = _logits_err([got.numpy()], [np.asarray(want)])
    assert err < 2e-5, err
    for name in ("k", "v"):
        a = cache[name][:, :, pos].float().numpy()
        b = np.asarray(jcache[name][:, :, pos], np.float32)
        assert _bf16_ulps(a, b) <= 1.0, name


def test_decode_from_a_reference_cache_mid_sequence(reduced):
    """The reference's bf16 cache after 66 steps, carried over bit for bit
    by ``cache_from_numpy``; the port continues from it."""
    r = reduced
    want, _, snap = _ref_decode_run(r, jnp.bfloat16, snap=66)
    cache = convert.cache_from_numpy(snap, device="cpu")
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        assert np.array_equal(
            cache[name].view(torch.int16).numpy().view(np.uint16),
            snap[name].view(np.uint16))
    got, _ = _port_decode_run(r, None, start=66, cache=cache)
    err = _logits_err(got, want[66:])
    assert err < 2e-5, err


def test_cache_from_numpy_f32_and_bad_inputs():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 1, 8, 2, 4)).astype(np.float32)
    cache = convert.cache_from_numpy({"k": k, "v": -k}, device="cpu")
    assert cache["k"].dtype == torch.float32
    assert np.array_equal(cache["v"].numpy(), -k)
    with pytest.raises(ValueError):
        convert.cache_from_numpy({"k": k}, device="cpu")
    with pytest.raises(ValueError):
        convert.cache_from_numpy({"k": k, "v": k.astype(np.float64)},
                                 device="cpu")


def test_kernel_adapter_matches_reference_jnp_path(reduced):
    """The port's ``make_attend_fn`` (each layer's window, the config's
    softcap) against the reference's plain decode, which honours both."""
    r = reduced
    want, _, _ = _ref_decode_run(r, jnp.float32)
    got, _ = _port_decode_run(r, torch.float32,
                              attend_fn=decode_attn.make_attend_fn(r["cfg"]))
    err = _logits_err(got, want)
    assert err < 2e-5, err


def test_decode_matches_teacher_forcing(reduced):
    """Decode stepping against the port's own teacher-forced forward, as
    ``tests/test_decode_consistency.py`` holds the reference."""
    r = reduced
    got, _ = _port_decode_run(r, torch.float32)
    toks = torch.from_numpy(r["toks"]).long()
    with torch.no_grad():
        h = tr.forward(r["params"], r["cfg"], toks)
        lt = tr.layers.softcap(
            torch.matmul(h, tr.lm_head_weight(r["params"], r["cfg"]))[
                ..., :r["cfg"].vocab], r["cfg"].final_softcap)
    pt = torch.log_softmax(lt, dim=-1).numpy()
    pd = torch.log_softmax(torch.from_numpy(np.stack(got, 1)), -1).numpy()
    assert np.abs(pt - pd).max() < 5e-5


def test_decode_raises_past_the_cache(reduced):
    r = reduced
    cache = model_api.make_cache(r["cfg"], 2, 4, kv_dtype=torch.float32,
                                 device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        model_api.decode(r["params"], r["cfg"], torch.zeros(2, 1).long(),
                         cache, 4)


def test_prefill_and_perplexity_match_reference(reduced):
    r = reduced
    toks = r["toks"][:, :70]
    want = np.asarray(japi.prefill(r["jparams"], r["jcfg"],
                                   tokens=jnp.asarray(toks)))
    got = model_api.prefill(r["params"], r["cfg"],
                            tokens=torch.from_numpy(toks).long())
    assert np.abs(got.detach().numpy() - want).max() < 1e-5
    labels = r["toks"][:, 1:71]
    jp = jserve.perplexity(r["jparams"], r["jcfg"], jnp.asarray(toks),
                           jnp.asarray(labels))
    tp = serve_utils.perplexity(r["params"], r["cfg"],
                                torch.from_numpy(toks).long(),
                                torch.from_numpy(labels).long())
    assert abs(tp - jp) <= 1e-5 * jp


# ---- sampling and generation ---------------------------------------------


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 0.0), (1.0, 0, 0.0), (0.7, 50, 0.0), (1.3, 0, 0.9),
    (0.8, 20, 0.5),
])
def test_sample_token_matches_reference_with_its_gumbel(temperature, top_k,
                                                        top_p):
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=(6, 512))).astype(np.float32)
    for i in range(4):
        key = jax.random.key(100 + i)
        want = np.asarray(jserve.sample_token(key, jnp.asarray(logits),
                                              temperature, top_k, top_p))
        g = torch.from_numpy(np.array(
            jax.random.gumbel(key, logits.shape, jnp.float32)))
        got = serve_utils.sample_token(torch.from_numpy(logits), temperature,
                                       top_k, top_p, gumbel=g)
        assert np.array_equal(got.numpy(), want)


def test_sample_token_draws_from_a_generator():
    logits = torch.zeros(4, 16)
    logits[:, 3] = 50.0
    g = torch.Generator().manual_seed(0)
    assert serve_utils.sample_token(logits, generator=g).tolist() == [3] * 4
    with pytest.raises(ValueError):
        serve_utils.sample_token(logits)


def test_generate_matches_reference_with_its_draws(reduced):
    r = reduced
    prompts = r["toks"][:, :10]
    gen_len, key = 6, jax.random.key(5)
    want, _ = jserve.generate(r["jparams"], r["jcfg"], jnp.asarray(prompts),
                              gen_len, key, temperature=0.8, top_k=40)
    # the reference splits its key once per sampled token
    draws, k = [], key
    for _ in range(gen_len):
        k, sk = jax.random.split(k)
        draws.append(np.asarray(jax.random.gumbel(
            sk, (2, r["cfg"].vocab), jnp.float32)))
    got, cache = serve_utils.generate(
        r["params"], r["cfg"], torch.from_numpy(prompts).long(), gen_len,
        temperature=0.8, top_k=40, gumbel=torch.from_numpy(np.stack(draws)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert cache["k"].dtype == torch.float32


def test_serving_params_cast_matrices_only():
    cfg = gemma2_2b.REDUCED
    params = model_api.init(cfg, device="cpu")
    sp = serve_utils.serving_params(
        params, dataclasses.replace(cfg, dtype=torch.bfloat16))
    for k, v in sp.items():
        assert v.dtype == (torch.float32 if k.endswith("/scale")
                           else torch.bfloat16), k


def test_serve_cli_runs_on_cpu_when_asked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--batch", "2", "--prompt-len", "70", "--gen-len", "4", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "tok/s" in proc.stdout
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("[serve] sample continuations: [[")
    toks = eval(line.split(":", 1)[1])
    assert np.asarray(toks).shape == (2, 4)
