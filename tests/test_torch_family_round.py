"""The MoE, RWKV-6 and Mamba2-hybrid families through the rest of the port:
one TAMUNA-DP round of each reduced config against the reference's
per-step composition, the train and serve CLIs on the CPU, the serving
cast, the registry, and the bf16 elementwise operations the new families
add, bitwise against XLA's.

The round follows ``tests/test_torch_round.py`` (n=4, c=3, s=2, L=2, the
cohort, the permutation derived from the reference's comm key, the DownCom
rows and the batches injected) on qwen2-moe-a2.7b, qwen3-moe-30b-a3b,
rwkv6-7b and zamba2-2.7b reduced: x and h within 1e-5 absolute, except
where ``H_TOL`` and ``EMBED_TOL`` say, rows the round does not touch
bit-exact, the counters within 1e-5 relative.  The exceptions are f32
rounding that the h update multiplies by eta/gamma (~4.5 here), measured
on the CPU: the embedding's gradients reach 3-5 at the round's perturbed
start, where the reference's f32 gradient of rwkv6's lies 2.4e-4 from a
float64 evaluation (the port's 5e-5) and zamba2's 1e-4 (both), so x
differs by up to 6.1e-5 and h by 2.8e-4; rwkv6's other h leaves by up to
2.2e-5; zamba2's by 4e-5, its scan's f32 roundings magnified by e^40
factors (``tests/test_torch_recurrent.py``).

The bf16 operations (100,000 normal inputs of scale 4, rounded to bf16):
XLA evaluates ``jnp.tanh`` on bf16 as the f32 tanh rounded once (so does
``torch.tanh``), ``jax.nn.sigmoid`` as ``1 / (1 + exp(-x))`` with every
operation rounded to bf16 (``torch.sigmoid`` rounds once and differs on
~34%: the port's ``layers.sigmoid``), ``jnp.square(jax.nn.relu(x))`` as
two rounded operations (``torch.square(torch.relu(x))``), and
``jax.nn.silu`` as ``x * (1 / (1 + exp(-x)))`` rounded at each step
(``layers.silu``).
"""

import dataclasses
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import registry as jregistry
from repro.dist import model_api as japi
from repro.dist import tamuna_dp as jtd
from repro_torch import serve_utils
from repro_torch.configs import registry
from repro_torch.dist import comm_ws, model_api, tamuna_dp
from repro_torch.launch import serve, train
from repro_torch.models import layers
from repro_torch.models.transformer import ModelConfig

NEW = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "rwkv6-7b", "zamba2-2.7b"]
N, C, S, L = 4, 3, 2, 2
SEQ, BATCH = 32, 2
COHORT = [0, 2, 3]
DOWN = np.array([True, False, True, True])  # row 1 idle in both cohorts
# h's tolerance per arch where it is not 1e-5, and the embedding's (x, h)
# (module docstring)
H_TOL = {"rwkv6-7b": 5e-5, "zamba2-2.7b": 1e-4}
EMBED_TOL = (1e-4, 5e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(arch):
    jcfg = jregistry.get_reduced_config(arch)
    tcfg = jtd.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = japi.init(jax.random.key(0), jcfg)
    names, leaves, treedef = checkpoint._flatten_with_names(params)
    rng = np.random.default_rng(7)
    x0 = [np.asarray(a)[None] + 0.01 * rng.normal(
        size=(N,) + a.shape).astype(np.float32) for a in leaves]
    h0 = [0.01 * rng.normal(size=(N,) + a.shape).astype(np.float32)
          for a in leaves]
    h0 = [(a - a.mean(axis=0, keepdims=True)).astype(np.float32)
          for a in h0]
    toks = rng.integers(0, jcfg.vocab, size=(L, C, BATCH, SEQ + 1))
    key = jax.random.key_data(jax.random.key(11))
    _, k_perm = jax.random.split(jax.random.wrap_key_data(key))
    perm = np.asarray(jax.random.permutation(k_perm, C))
    return dict(
        arch=arch, jcfg=jcfg, tcfg=tcfg, mesh=mesh, names=names,
        treedef=treedef, x0=x0, h0=h0, toks=toks.astype(np.int32), key=key,
        perm=perm, local=jax.jit(jtd.make_local_step(jcfg, tcfg)),
        comm=jax.jit(jtd.make_comm_step(jcfg, tcfg, mesh, impl="ws", n=N)))


def _run_reference(ref, x0):
    unflat = lambda ls: jax.tree.unflatten(ref["treedef"],
                                           [jnp.asarray(a) for a in ls])
    zero = jnp.zeros((), jnp.float32)
    state = jtd.DistTamunaState(
        x=unflat(x0), h=unflat(ref["h0"]), opt=(),
        round=jnp.zeros((), jnp.int32), up_floats=zero, down_floats=zero,
        up_bytes=zero, down_bytes=zero)
    cohort = jnp.asarray(COHORT, jnp.int32)
    compact = jtd.gather_cohort(state, cohort)
    for t in range(L):
        tk = jnp.asarray(ref["toks"][t])
        compact, _ = ref["local"](compact, tokens=tk[..., :-1],
                                  labels=tk[..., 1:])
    state = jtd.scatter_cohort(state, compact, cohort)
    return ref["comm"](state, ref["key"], cohort=cohort,
                       down=jnp.asarray(DOWN))


def _run_port(ref, x0):
    cfg = registry.get_reduced_config(ref["arch"])
    tcfg = tamuna_dp.DistTamunaConfig(gamma=0.05, c=C, s=S, p=0.34)
    spec = comm_ws.workspace_spec(model_api.param_specs(cfg))
    assert list(spec.names) == ref["names"]
    x = torch.empty(N, spec.d_total)
    h = torch.empty(N, spec.d_total)
    comm_ws.pack({n: torch.from_numpy(a) for n, a in
                  zip(ref["names"], x0)}, spec, x)
    comm_ws.pack({n: torch.from_numpy(a) for n, a in
                  zip(ref["names"], ref["h0"])}, spec, h)
    state = tamuna_dp.DistTamunaState(x=x, h=h, spec=spec)
    local = tamuna_dp.make_local_step(cfg, tcfg)
    compact = tamuna_dp.gather_cohort(state, COHORT)
    for t in range(L):
        tk = torch.from_numpy(ref["toks"][t]).long()
        local(compact, tokens=tk[..., :-1], labels=tk[..., 1:])
    state = tamuna_dp.scatter_cohort(state, compact)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, N, device="cpu")
    return comm(state, COHORT, ref["perm"].tolist(), torch.from_numpy(DOWN))


@pytest.mark.parametrize("arch", NEW)
def test_round_matches_reference_per_step_composition(arch):
    """One round (the MoE configs' local steps differentiate the loss with
    its load-balance term, as the reference's do)."""
    ref = _reference(arch)
    x0 = [a.copy() for a in ref["x0"]]
    for a in x0:
        a[1] = np.nan  # an idle row may hold anything
    want = _run_reference(ref, x0)
    got = _run_port(ref, x0)
    gx = comm_ws.unpack(got.x, got.spec)
    gh = comm_ws.unpack(got.h, got.spec)
    for name, wx, wh in zip(ref["names"], jax.tree.leaves(want.x),
                            jax.tree.leaves(want.h)):
        wx, wh = np.asarray(wx), np.asarray(wh)
        live = ~np.isnan(wx)
        assert np.array_equal(np.isnan(gx[name].numpy()), ~live), name
        ex = np.abs(gx[name].numpy()[live] - wx[live]).max()
        eh = np.abs(gh[name].numpy() - wh).max()
        xt, ht = (EMBED_TOL if name == "embed"
                  else (1e-5, H_TOL.get(arch, 1e-5)))
        assert ex <= xt, (name, ex)
        assert eh <= ht, (name, eh)
    x0f = np.concatenate([a.reshape(N, -1) for a in x0], axis=1)
    h0f = np.concatenate([a.reshape(N, -1) for a in ref["h0"]], axis=1)
    assert got.h[1].numpy().tobytes() == h0f[1].tobytes()
    assert got.x[1].numpy().tobytes() == x0f[1].tobytes()
    assert np.abs(got.h.sum(0).numpy()).max() < 1e-6
    assert got.round == int(want.round) == 1
    for k in ("up_floats", "down_floats", "up_bytes", "down_bytes"):
        w = float(getattr(want, k))
        assert abs(getattr(got, k) - w) <= 1e-5 * w, k


def _bf16_inputs():
    x = np.random.default_rng(0).normal(size=100_000).astype(np.float32) * 4
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("op", ["tanh", "sigmoid", "relu_square", "silu"])
def test_bf16_elementwise_ops_are_xlas_bitwise(op):
    """Each bf16 elementwise operation of the new families, as the port
    writes it, against ``jax.jit`` of the reference's (module docstring),
    bit for bit on 100,000 inputs."""
    xb, xt = _bf16_inputs()
    ref_fn, port_fn = {
        "tanh": (jnp.tanh, torch.tanh),
        "sigmoid": (jax.nn.sigmoid, layers.sigmoid),
        "relu_square": (lambda a: jnp.square(jax.nn.relu(a)),
                        lambda a: torch.square(torch.relu(a))),
        "silu": (jax.nn.silu, layers.silu),
    }[op]
    want = np.asarray(jax.jit(ref_fn)(xb).astype(jnp.float32))
    got = port_fn(xt)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)
    if op == "sigmoid":  # the one-rounding form is not XLA's
        once = torch.sigmoid(xt).float().numpy()
        assert (once != want).mean() > 0.2


def test_registry_and_families():
    """The registry lists the four new architectures beside the dense
    ones and whisper-tiny's encoder-decoder; ``ModelConfig`` takes the five
    ported families and refuses any other."""
    archs = registry.list_archs()
    assert set(NEW) <= set(archs) and len(archs) == 10
    assert {registry.get_config(a).family for a in archs} == {
        "dense", "moe", "rwkv", "mamba_hybrid", "encdec"}
    with pytest.raises(ValueError, match="not ported"):
        ModelConfig(family="diffusion")


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b",
                                  "qwen2-moe-a2.7b"])
def test_serving_params_keep_the_f32_reads_and_the_bits(arch):
    """``cast_for_serving_`` on a bf16 version of the reduced config casts
    every leaf the model reads in the compute dtype and keeps the f32
    reads (norm scales, ``w_base``, ``u``, ``A_log``, ``D``, ``dt_bias``,
    ``conv_w``, ``conv_b``) in f32, in place; 6 decode steps with the cast
    parameters give the same logits and cache, bit for bit, as with the f32
    originals."""
    cfg = dataclasses.replace(registry.get_reduced_config(arch),
                              dtype=torch.bfloat16)
    params = model_api.init(cfg, seed=3, device="cpu")
    f32 = {k: v.clone() for k, v in params.items()}
    serve_utils.cast_for_serving_(params, cfg)
    assert list(params) == list(f32)
    for k, v in params.items():
        keep = k.endswith(serve_utils.F32_LEAVES)
        assert v.dtype == (torch.float32 if keep else torch.bfloat16), k
        assert torch.equal(v, f32[k].to(v.dtype)), k
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 6)))
    out = []
    for p in (f32, params):
        cache = model_api.make_cache(cfg, 2, 6, device="cpu")
        with torch.no_grad():
            for i in range(6):
                lg, cache = model_api.decode(p, cfg, toks[:, i:i + 1], cache,
                                             i)
        out.append((lg, cache))
    (la, ca), (lb, cb) = out
    assert torch.equal(la, lb)
    for k in ca:
        assert torch.equal(ca[k], cb[k]), k


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "rwkv6-7b"])
def test_train_cli_trains_the_new_families_on_cpu(arch, capsys):
    """The train CLI's ``main``, in this process."""
    assert train.main(["--arch", arch, "--reduced", "--rounds", "2",
                       "--seq-len", "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"on cpu in [0-9.]+s; final loss (\S+)$", out.strip())
    assert m and math.isfinite(float(m.group(1))), out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "rwkv6-7b"])
def test_serve_cli_serves_the_new_families_on_cpu(arch, capsys):
    """The serve CLI's ``main``, in this process."""
    assert serve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen-len", "4", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"sample continuations: (\[\[.*\]\])", out)
    assert m, out
    toks = json.loads(m.group(1))
    assert len(toks) == 2 and all(len(t) == 4 for t in toks)
    vocab = registry.get_reduced_config(arch).vocab
    assert all(0 <= x < vocab for t in toks for x in t)
