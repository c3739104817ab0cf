"""The model's memory options (``ModelConfig.remat``, ``param_dtype``), the
blockwise attention's recomputing backward and the ``REPRO_DISABLE_FLASH``
switch, against the reference where it has a counterpart.

* ``remat`` (``torch.utils.checkpoint`` per layer, where the reference
  wraps its scanned bodies in ``jax.checkpoint``) leaves the loss and the
  gradients of all five families bitwise as they are without it (the CPU
  recomputes each layer in the same order), and the tensors autograd
  keeps outside the recomputed layers fall to a few of the layer inputs'
  size (the hybrid also keeps its weight-shared block, which the
  reference does not recompute either).
* ``layers.flash_attention``'s backward against ``jax.grad`` of the
  reference's ``layers.flash_attention`` with ``k_chunk=64`` at t = 256
  and t = 200 (a ragged last block), GQA group 2: the window or none, the
  softcap or none, causal or not.  f32 within 2e-6 of each gradient's
  largest entry (measured up to 9.8e-7: the two sum the blocks'
  contributions in other orders, and the port takes the softcap's
  derivative as ``1 - tanh^2`` where autograd multiplies by the cap and
  divides again), bf16 within 1e-2 (measured up to 7.0e-3: the gradients
  are rounded to bf16 at other places).  The Function saves nothing with
  a block axis.
* ``param_dtype=torch.bfloat16``: the reference's leaf names, shapes and
  dtype, a bf16 reference init carried over bit for bit and back, and the
  round's casts (x written back in bf16, h in f32), held against the
  reference's local and comm steps, with and without faults.
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
from repro.configs import registry as jregistry
from repro.dist import faults as jfaults
from repro.dist import model_api as japi
from repro.dist import tamuna_dp as jtd
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist import comm_ws, faults, model_api, rounds, tamuna_dp
from repro_torch.models import encdec, layers, transformer

ARCHS = ("gemma2-2b", "qwen2-moe-a2.7b", "rwkv6-7b", "zamba2-2.7b",
         "whisper-tiny")
T = 32  # zamba2's scan overflows f32 from 64 tokens at its init


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg):
    g = torch.Generator().manual_seed(3)
    kw = dict(tokens=torch.randint(0, cfg.vocab, (2, T), generator=g),
              labels=torch.randint(0, cfg.vocab, (2, T), generator=g))
    if cfg.family == "encdec":
        kw["frames"] = torch.randn(2, cfg.n_frames, cfg.d_model, generator=g)
    return kw


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_grads_equal_no_remat(arch):
    cfg = registry.get_reduced_config(arch)
    assert cfg.remat  # on by default, as the reference's
    params = model_api.init(cfg, seed=0, device="cpu")
    kw = _inputs(cfg)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, _ = model_api.loss(ps, c, **kw)
        out.append((loss, torch.autograd.grad(loss, list(ps.values()))))
    (l0, g0), (l1, g1) = out
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    for name, a, b in zip(params, g0, g1):
        assert torch.equal(a, b), name


def _saved_bytes(fn):
    """Bytes of the tensors autograd saves, outside any checkpointed
    layer (a checkpoint installs its own hooks inside)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_only_the_layer_inputs(arch):
    """With ``remat`` the forward keeps a few layer inputs' worth (the
    embedding's, the positions' and the final norm's, plus the hybrid's
    weight-shared block, not recomputed as in the reference); without it,
    every layer's activations (measured 168-450 layer inputs' worth
    here)."""
    cfg = registry.get_reduced_config(arch)
    params = {k: v.requires_grad_(True) for k, v in
              model_api.init(cfg, seed=0, device="cpu").items()}
    kw = _inputs(cfg)
    width = max(T, cfg.n_frames)
    x_bytes = 2 * width * cfg.d_model * 4

    def forward(c):
        if c.family == "encdec":
            return lambda: encdec.decode_train(
                params, c, kw["tokens"], encdec.encode(params, c,
                                                       kw["frames"]))
        return lambda: transformer.forward_aux(params, c, kw["tokens"])

    off = _saved_bytes(forward(dataclasses.replace(cfg, remat=False)))
    on = _saved_bytes(forward(cfg))
    shared = 0
    if cfg.family == "mamba_hybrid":
        x = torch.randn(2, T, cfg.d_model, requires_grad=True)
        shared = transformer._groups(cfg) * _saved_bytes(
            lambda: transformer._shared_block(params, x, cfg))
    # measured 6-10 layer inputs' worth beside the shared block
    assert on - shared <= 12 * x_bytes, (on, shared, x_bytes)
    assert off - shared >= 20 * (on - shared), (off, on, shared)


# -- the blockwise attention's backward against jax.grad ---------------------

H, KVH, HD, CHUNK = 4, 2, 16, 64
FLASH_CASES = [  # (t, window, softcap, causal)
    (256, None, None, True), (256, 48, 50.0, True), (200, 48, None, True),
    (200, None, 50.0, True), (256, None, 50.0, False),
    (200, None, None, False)]


def _reference_grads(q, k, v, do, t, window, cap, causal):
    def f(q, k, v):
        out = jlayers.flash_attention(
            q, k, v, causal=causal,
            window=None if window is None else jnp.int32(window),
            attn_softcap=cap, k_chunk=CHUNK)
        return (out.astype(jnp.float32) * do).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return out, grads


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("t,window,cap,causal", FLASH_CASES)
def test_flash_backward_matches_reference_grad(t, window, cap, causal, dtype,
                                               tol):
    rng = np.random.default_rng(t + (window or 0) + int(causal))
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = (rng.normal(size=(1, t, h, HD)).astype(npdt)
               for h in (H, KVH, KVH))
    do = rng.normal(size=(1, t, H, HD)).astype(np.float32)
    want_out, want = _reference_grads(q, k, v, do, t, window, cap, causal)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
                  .requires_grad_(True) for a in (q, k, v))
    out = layers.flash_attention(
        tq, tk, tv, window=t + 1 if window is None else window,
        attn_softcap=cap, k_chunk=CHUNK, causal=causal)
    assert out.dtype == tdt
    got = torch.autograd.grad((out.float() * torch.from_numpy(do)).sum(),
                              (tq, tk, tv))
    wo = np.asarray(want_out, np.float32)
    assert np.abs(out.detach().float().numpy() - wo).max() <= \
        tol * np.abs(wo).max()
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt, name
        w = np.asarray(w, np.float32)
        err = np.abs(g.float().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (name, err / np.abs(w).max())


def test_flash_saves_no_block_tensor():
    """The Function saves q, k, v, the f32 output and the rows' max and
    denominator; autograd through the chunk loop saves tensors with the
    block axis."""
    t = 256
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, t, H, HD, generator=g, requires_grad=True)
    k, v = (torch.randn(1, t, KVH, HD, generator=g, requires_grad=True)
            for _ in range(2))

    def shapes(fn):
        seen = []

        def pack(x):
            seen.append(tuple(x.shape))
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            fn(q, k, v, window=t + 1, attn_softcap=50.0, k_chunk=CHUNK)
        return seen

    fn_shapes = shapes(layers.flash_attention)
    assert all(CHUNK not in s for s in fn_shapes), fn_shapes
    o, m = (1, KVH, H // KVH, t, HD), (1, KVH, H // KVH, t, 1)
    assert sorted(fn_shapes) == sorted([tuple(q.shape), tuple(k.shape),
                                        tuple(v.shape), o, m, m])
    assert any(s and s[-1] == CHUNK
               for s in shapes(layers.flash_attention_plain))


def test_disable_flash_gives_the_dense_path_at_2048():
    """``REPRO_DISABLE_FLASH=1`` at import: the threshold is 10**12 and an
    attention at 2048 tokens takes the dense ``attention_scores``, as the
    reference's override; without it the blockwise path."""
    code = r"""
import torch
from repro_torch.models import layers
calls = []
for name in ("flash_attention", "attention_scores"):
    real = getattr(layers, name)
    setattr(layers, name, lambda *a, _n=name, _r=real, **k: (
        calls.append(_n), _r(*a, **k))[1])
g = torch.Generator().manual_seed(0)
x = torch.randn(1, 2048, 16, generator=g)
ws = [torch.randn(16, 16, generator=g) for _ in range(4)]
layers.attention(x, *ws, n_heads=2, n_kv_heads=2, head_dim=8,
                 rope_theta=None, window=4096, attn_softcap=None)
print(layers.FLASH_THRESHOLD, calls)
"""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    out = {}
    for flag in ("1", "0"):
        env["REPRO_DISABLE_FLASH"] = flag
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        out[flag] = proc.stdout.strip()
    assert out["1"] == "1000000000000 ['attention_scores']"
    assert out["0"] == "2048 ['flash_attention']"


# -- param_dtype -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_params_are_the_references_and_convert_both_ways(arch):
    jcfg = dataclasses.replace(jregistry.get_reduced_config(arch),
                               param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(registry.get_reduced_config(arch),
                              param_dtype=torch.bfloat16)
    jparams = japi.init(jax.random.key(0), jcfg)
    names, jleaves, _ = checkpoint._flatten_with_names(jparams)
    params = model_api.init(cfg, seed=0, device="cpu")
    assert list(params) == names
    for (name, p), a in zip(params.items(), jleaves):
        assert tuple(p.shape) == a.shape, name
        assert p.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16, name
    # the reference's bf16 init -> the port, bit for bit, and back
    arrays = {n: np.asarray(a) for n, a in zip(names, jleaves)}
    ported = convert.params_from_numpy(arrays, cfg, "cpu")
    back = convert.params_to_numpy(ported)
    for n in names:
        assert ported[n].dtype == torch.bfloat16, n
        bits = arrays[n].view(np.uint16)
        assert back[n].dtype == np.uint16
        np.testing.assert_array_equal(back[n], bits, err_msg=n)
        np.testing.assert_array_equal(
            back[n].view(ml_dtypes.bfloat16), arrays[n], err_msg=n)


def test_bf16_round_casts_x_and_keeps_h_in_f32():
    """The reference's round keeps x in the parameters' dtype and h in f32
    (``astype(x.dtype)`` after each local step, ``unpack`` after the comm
    step).  Two rounds of reduced gemma2-2b with bf16 parameters: every
    row of x holds bf16 values, h does not, and the first local step is
    ``(x - gamma (g - h))`` rounded to bf16 with g the gradient of the
    bf16 leaves."""
    cfg = dataclasses.replace(registry.get_reduced_config("gemma2-2b"),
                              param_dtype=torch.bfloat16)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=3, s=2, p=0.5)
    n = 4
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    x0 = state.x[0].clone()
    assert torch.equal(x0, x0.bfloat16().float())
    pipe = SyntheticTokenPipeline(
        DataConfig(seq_len=16, per_client_batch=1, vocab=64, seed=0,
                   n_clients=n), cfg, "cpu")
    # one local step of member 0 by hand
    batch = pipe.sample_batch([0])
    spec = state.spec
    leaves = {k: v.detach().bfloat16().requires_grad_(True)
              for k, v in comm_ws.leaf_views(x0, spec).items()}
    loss, _ = model_api.loss(leaves, cfg, tokens=batch["tokens"][0],
                             labels=batch["labels"][0])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = torch.cat([(leaves[k].detach().float() - 0.05 * g.float())
                      .bfloat16().float().reshape(-1)
                      for k, g in zip(leaves, grads)])
    local = tamuna_dp.make_local_step(cfg, tcfg)
    compact = tamuna_dp.gather_cohort(state, [0])
    pipe2 = SyntheticTokenPipeline(
        DataConfig(seq_len=16, per_client_batch=1, vocab=64, seed=0,
                   n_clients=n), cfg, "cpu")
    local(compact, **pipe2.sample_batch([0]))
    assert torch.equal(state.x[0], want)
    # two rounds: x bf16 everywhere, h f32
    state = tamuna_dp.init_state(cfg, tcfg, n, seed=0, device="cpu")
    state, rows = rounds.run_rounds(
        state, cfg=cfg, tcfg=tcfg, pipe=pipe, rounds=2,
        rng=np.random.default_rng(0),
        generator=torch.Generator().manual_seed(1), max_L=2)
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert torch.equal(state.x, state.x.bfloat16().float())
    assert state.h.abs().max() > 0
    assert not torch.equal(state.h, state.h.bfloat16().float())



BN, BC, BS = 5, 4, 2  # population, cohort, s
B_COHORT = [0, 1, 3, 4]
B_DOWN = np.array([True, True, False, True, True])  # row 2 idle
B_ARRIVED = np.array([True, True, False, False, True])  # member 3 dropped
B_CORRUPT = np.array([False, False, False, True, False])  # and blown up
B_BYZ = np.array([False, False, False, False, True])  # an inlier


def _bf16_ulp(a):
    """One bf16 ulp of ``|a|``'s largest entry (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


@pytest.fixture(scope="module")
def bf16_reference():
    """The inputs of ``test_bf16_round_matches_reference`` and the
    reference's state after its local step (reduced gemma2-2b, bf16
    parameters)."""
    jcfg = dataclasses.replace(jregistry.get_reduced_config("gemma2-2b"),
                               param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(registry.get_reduced_config("gemma2-2b"),
                              param_dtype=torch.bfloat16)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    names, leaves, treedef = checkpoint._flatten_with_names(
        japi.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(7)
    x0 = [(np.asarray(a, np.float32)[None] + 0.01 * rng.normal(
        size=(BN,) + a.shape)).astype(ml_dtypes.bfloat16) for a in leaves]
    h0 = [0.01 * rng.normal(size=(BN,) + a.shape).astype(np.float32)
          for a in leaves]
    h0 = [(a - a.mean(axis=0, keepdims=True)).astype(np.float32)
          for a in h0]
    key = jax.random.key_data(jax.random.key(11))
    _, k_perm = jax.random.split(jax.random.wrap_key_data(key))
    perm = np.asarray(jax.random.permutation(k_perm, BC)).tolist()
    dcfg = DataConfig(seq_len=16, per_client_batch=1, vocab=jcfg.vocab,
                      seed=0, n_clients=BN)
    batch = SyntheticTokenPipeline(dcfg, cfg, "cpu").sample_batch(B_COHORT)
    jtcfg = jtd.DistTamunaConfig(gamma=0.05, c=BC, s=BS, p=0.34)
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=BC, s=BS, p=0.34)

    # the reference's local step
    unflat = lambda ls: jax.tree.unflatten(treedef,
                                           [jnp.asarray(a) for a in ls])
    zero = jnp.zeros((), jnp.float32)
    state = jtd.DistTamunaState(
        x=unflat(x0), h=unflat(h0), opt=(), round=jnp.zeros((), jnp.int32),
        up_floats=zero, down_floats=zero, up_bytes=zero, down_bytes=zero)
    cohort = jnp.asarray(B_COHORT, jnp.int32)
    compact, _ = jax.jit(jtd.make_local_step(jcfg, jtcfg))(
        jtd.gather_cohort(state, cohort),
        tokens=jnp.asarray(batch["tokens"].numpy()),
        labels=jnp.asarray(batch["labels"].numpy()))
    state = jtd.scatter_cohort(state, compact, cohort)
    local_x = [np.asarray(a).astype(np.float32)
               for a in jax.tree.leaves(state.x)]
    local_h = [np.asarray(a) for a in jax.tree.leaves(state.h)]
    return dict(jcfg=jcfg, cfg=cfg, mesh=mesh, names=names, x0=x0, h0=h0,
                key=key, perm=perm, dcfg=dcfg, batch=batch, jtcfg=jtcfg,
                tcfg=tcfg, state=state, cohort=cohort, local_x=local_x,
                local_h=local_h)


@pytest.mark.parametrize("faulted", [False, True], ids=["plain", "faulted"])
def test_bf16_round_matches_reference(bf16_reference, faulted):
    """One round of reduced gemma2-2b with bf16 parameters, one local step
    then the comm step, the reference's against the port's on the same
    cohort, batch, permutation and starting x (bf16) and h (f32).
    ``plain`` runs the port's local and comm steps (the rounding after
    the local step and after the DownCom); ``faulted`` the port's round
    halves (``make_pipelined_round_fn``'s stage and commit) with a
    blown-up member caught by the guard, a dropped member and an inlier
    adversary, against the reference's commit body composed step by step
    (the rounding of the injected payloads).

    After the local step x matches in all but a few coordinates: both
    take the gradients of the bf16 leaves, which the two frameworks
    round to bf16 from f32 values an f32 rounding apart, and where one
    lands on the other side of a bf16 rounding boundary x moves by
    ``gamma`` bf16 ulps of the gradient or one of its own.  Held to 1% of
    each leaf's coordinates, each within one bf16 ulp of the leaf's
    largest entry; measured 0.59% of the embedding's coordinates at
    that one ulp and at most 0.0043% of any other leaf's at half an ulp.
    A rounding left out would move nearly every coordinate.  The
    comm half then starts both from the reference's x and h after the
    local step, so its x is held bitwise and its h within 1e-5, the f32
    tolerance of the f32 rounds (``test_torch_family_round``)."""
    r = bf16_reference
    jcfg, cfg, names, perm, dcfg, batch = (
        r[k] for k in ("jcfg", "cfg", "names", "perm", "dcfg", "batch"))
    state, cohort, local_x, local_h = (
        r[k] for k in ("state", "cohort", "local_x", "local_h"))
    tcfg = r["tcfg"]
    guard_max_abs = 1e4
    model = faults.FaultModel(corrupt_mode="blowup", adversary="inlier")
    comm = jax.jit(jtd.make_comm_step(jcfg, r["jtcfg"], r["mesh"],
                                      impl="ws", n=BN),
                   static_argnames=("correct",))
    kw = {}
    if faulted:  # rounds.make_pipelined_round_fn's commit_fn, step by step
        member = np.zeros(BN, bool)
        member[B_COHORT] = True
        x = jfaults.corrupt_rows(state.x, B_CORRUPT, "blowup", model.blowup)
        arr = B_ARRIVED & member
        x = jfaults.adversarial_rows(x, B_BYZ & arr, arr & ~B_BYZ, "inlier",
                                     byz_z=model.byz_z)
        bad = np.asarray(jfaults.nonfinite_clients(x, guard_max_abs)) & member
        assert bad.tolist() == B_CORRUPT.tolist()
        arr = arr & ~bad
        x = jax.tree.map(lambda a: jnp.where(
            bad.reshape((BN,) + (1,) * (a.ndim - 1)),
            jnp.zeros((), a.dtype), a), x)
        state = state._replace(x=x)
        kw = dict(arrived=jnp.asarray(arr), correct=True)
    want = comm(state, r["key"], cohort=cohort, down=jnp.asarray(B_DOWN),
                **kw)

    # the port: the local step ...
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    assert list(spec.names) == names
    ws = lambda leaves: comm_ws.pack(
        {n: torch.from_numpy(np.asarray(a, np.float32))
         for n, a in zip(names, leaves)}, spec, torch.empty(BN, spec.d_total))
    x, h = ws(r["x0"]), ws(r["h0"])
    got = tamuna_dp.DistTamunaState(x=x.clone(), h=h.clone(), spec=spec)
    if faulted:
        engine = rounds.make_pipelined_round_fn(
            cfg, tcfg, BN, pipe=SyntheticTokenPipeline(dcfg, cfg, "cpu"),
            max_L=1, elastic=True, coverage=False, device="cpu")
        buf = engine.stage(got, 1, B_COHORT)
    else:
        tamuna_dp.make_local_step(cfg, tcfg)(
            tamuna_dp.gather_cohort(got, B_COHORT), **batch)
    gx = comm_ws.unpack(got.x, spec)
    for name, wx in zip(names, local_x):
        diff = gx[name].numpy() != wx
        err = np.abs(gx[name].numpy() - wx).max() / _bf16_ulp(wx)
        assert diff.mean() <= 0.01, (name, diff.mean())
        assert err <= 1.0, (name, err)
    assert torch.equal(got.x, got.x.bfloat16().float())
    assert torch.equal(got.h, h)
    # ... and the comm step from the reference's x and h after it
    got.x.copy_(ws(local_x))
    got.h.copy_(ws(local_h))
    if faulted:
        got, info = engine.commit(
            got, buf, B_COHORT, torch.from_numpy(B_DOWN), perm=perm,
            arrived=B_ARRIVED, corrupt=B_CORRUPT, byz=B_BYZ, model=model,
            guard=True, guard_max_abs=guard_max_abs)
        assert info["bad"].tolist() == B_CORRUPT.tolist()
        assert info["arrived"].tolist() == arr.tolist()
    else:
        got = tamuna_dp.make_comm_step(cfg, tcfg, BN, device="cpu")(
            got, B_COHORT, perm, torch.from_numpy(B_DOWN))
    gx = comm_ws.unpack(got.x, spec)
    gh = comm_ws.unpack(got.h, spec)
    for name, wx, wh in zip(names, jax.tree.leaves(want.x),
                            jax.tree.leaves(want.h)):
        assert wx.dtype == jnp.bfloat16 and wh.dtype == jnp.float32, name
        wx = np.asarray(wx).astype(np.float32)
        np.testing.assert_array_equal(gx[name].numpy(), wx, err_msg=name)
        assert np.abs(gh[name].numpy() - np.asarray(wh)).max() <= 1e-5, name
    # the idle row keeps its x and h bit for bit
    assert torch.equal(got.x[2], x[2]) and torch.equal(got.h[2], h[2])
