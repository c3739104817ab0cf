"""One full TAMUNA-DP round of the port against the reference's per-step
composition (``gather_cohort`` -> ``make_local_step`` x L ->
``scatter_cohort`` -> ``make_comm_step(impl="ws")`` on a 1x1 mesh), with
the cohort, the permutation, the DownCom rows and the batches injected.

n=4, c=3, s=2, L=2 on the reduced gemma2-2b, stablelm-3b (q/k/v biases,
untied head) and internvl2-26b (untied head; each batch with the same
``prefix_embeds`` on both sides) configs.  The permutation is
derived from the comm key exactly as the reference's comm step derives it
(``tamuna_dp.py:582-586``).  x and h agree to 1e-5 absolute (the two
frameworks sum the gradients' products in different orders; the h update
multiplies those differences by eta/gamma), the float counters to 1e-5
relative; rows the round does not touch are bit-exact, NaN payload
included.  One exception, h of stablelm-3b's untied embedding, is held to
2e-5 (``H_TOL``): its gradients reach 4.0 (gemma2-2b's embedding is tied
and scaled), both frameworks' f32 gradients lie ~4e-6 of the largest from
a float64 evaluation (``tests/test_torch_family.py``), and through the
h update that rounding gives 1.25e-5 (measured on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint
from repro.configs import registry as jregistry
from repro.dist import model_api as japi
from repro.dist import tamuna_dp as jtd
from repro_torch.configs import registry
from repro_torch.dist import comm_ws, model_api, tamuna_dp

N, C, S, L = 4, 3, 2, 2
SEQ, BATCH = 32, 2
COHORT = [0, 2, 3]
# h's tolerance per (arch, leaf) where it is not 1e-5 (module docstring)
H_TOL = {("stablelm-3b", "embed"): 2e-5}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's spinning thread pools slow each other down when they
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module",
                params=["gemma2-2b", "stablelm-3b", "internvl2-26b"])
def reference(request):
    arch = request.param
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
    pe = (rng.normal(size=(L, C, BATCH, jcfg.prefix_len, jcfg.d_model))
          .astype(np.float32) if jcfg.prefix_len else None)
    key = jax.random.key_data(jax.random.key(11))
    _, k_perm = jax.random.split(jax.random.wrap_key_data(key))
    perm = np.asarray(jax.random.permutation(k_perm, C))
    return dict(
        arch=arch, pe=pe, jcfg=jcfg, tcfg=tcfg, mesh=mesh, names=names, treedef=treedef,
        x0=x0, h0=h0, toks=toks.astype(np.int32), key=key, perm=perm,
        local=jax.jit(jtd.make_local_step(jcfg, tcfg)),
        comm=jax.jit(jtd.make_comm_step(jcfg, tcfg, mesh, impl="ws", n=N)),
    )


def _run_reference(ref, x0, down):
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
        kw = {} if ref["pe"] is None else {
            "prefix_embeds": jnp.asarray(ref["pe"][t])}
        compact, _ = ref["local"](compact, tokens=tk[..., :-1],
                                  labels=tk[..., 1:], **kw)
    state = jtd.scatter_cohort(state, compact, cohort)
    return ref["comm"](state, ref["key"], cohort=cohort,
                       down=jnp.asarray(down))


def _run_port(ref, x0, down):
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
        kw = {} if ref["pe"] is None else {
            "prefix_embeds": torch.from_numpy(ref["pe"][t])}
        local(compact, tokens=tk[..., :-1], labels=tk[..., 1:], **kw)
    state = tamuna_dp.scatter_cohort(state, compact)
    comm = tamuna_dp.make_comm_step(cfg, tcfg, N, device="cpu")
    return comm(state, COHORT, ref["perm"].tolist(),
                torch.from_numpy(down))


@pytest.mark.parametrize("down", [
    np.array([True, False, True, True]),  # row 1 idle in both cohorts
    np.array([True, True, False, True]),  # row 1 joins, row 2 leaves
])
def test_round_matches_reference_per_step_composition(reference, down):
    ref = reference
    x0 = [a.copy() for a in ref["x0"]]
    if not down[1]:
        for a in x0:
            a[1] = np.nan  # an idle row may hold anything
    want = _run_reference(ref, x0, down)
    got = _run_port(ref, x0, down)

    gx = comm_ws.unpack(got.x, got.spec)
    gh = comm_ws.unpack(got.h, got.spec)
    for name, wx, wh in zip(ref["names"], jax.tree.leaves(want.x),
                            jax.tree.leaves(want.h)):
        wx, wh = np.asarray(wx), np.asarray(wh)
        live = ~np.isnan(wx)
        assert np.array_equal(np.isnan(gx[name].numpy()), ~live), name
        ex = np.abs(gx[name].numpy()[live] - wx[live]).max()
        eh = np.abs(gh[name].numpy() - wh).max()
        assert ex <= 1e-5, (name, ex)
        assert eh <= H_TOL.get((ref["arch"], name), 1e-5), (name, eh)

    x0f = np.concatenate([a.reshape(N, -1) for a in x0], axis=1)
    h0f = np.concatenate([a.reshape(N, -1) for a in ref["h0"]], axis=1)
    # rows outside the cohort keep h bit for bit; rows outside both the
    # cohort and the DownCom keep x bit for bit
    for i in set(range(N)) - set(COHORT):
        assert got.h[i].numpy().tobytes() == h0f[i].tobytes()
        if not down[i]:
            assert got.x[i].numpy().tobytes() == x0f[i].tobytes()
    # cohort rows that do not download keep their trained x: not x_bar
    for i in set(COHORT) - set(np.flatnonzero(down)):
        assert not np.array_equal(got.x[i].numpy(), got.x[0].numpy())
    # sum_i h_i == 0 survives the round
    assert np.abs(got.h.sum(0).numpy()).max() < 1e-6

    assert got.round == int(want.round) == 1
    for k in ("up_floats", "down_floats", "up_bytes", "down_bytes"):
        w = float(getattr(want, k))
        assert abs(getattr(got, k) - w) <= 1e-5 * w, k
