"""The port's host-side streams against the reference: the per-client
transition tables and the geometric round lengths agree bitwise; the
device sampler draws valid Markov chains from them."""

import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jgemma
from repro.data import pipeline as jpipe
from repro.dist import tamuna_dp as jtd
from repro_torch.configs import gemma2_2b
from repro_torch.data import pipeline
from repro_torch.dist import tamuna_dp


@pytest.mark.parametrize("n,mix", [(4, 1.0), (3, 0.5)])
def test_transition_tables_match_reference(n, mix):
    kw = dict(seq_len=8, per_client_batch=2, vocab=64, seed=5,
              heterogeneity=mix, n_clients=n)
    want = jpipe.SyntheticTokenPipeline(jpipe.DataConfig(**kw),
                                        jgemma.REDUCED).trans
    got = pipeline.transition_tables(pipeline.DataConfig(**kw),
                                     gemma2_2b.REDUCED)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_round_lengths_match_reference():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    want = [jtd.sample_round_length(a, 0.34, max_L=4) for _ in range(200)]
    got = [tamuna_dp.sample_round_length(b, 0.34, max_L=4)
           for _ in range(200)]
    assert got == want and max(got) == 4


def test_device_sampler_draws_chains_of_the_tables():
    dcfg = pipeline.DataConfig(seq_len=40, per_client_batch=3, vocab=16,
                               seed=1, n_clients=4)
    pipe = pipeline.SyntheticTokenPipeline(dcfg, gemma2_2b.REDUCED, "cpu")
    batch = pipe.sample_batch([3, 0])
    toks, labels = batch["tokens"], batch["labels"]
    assert toks.shape == labels.shape == (2, 3, 40)
    assert toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < 16
    # labels are the next tokens
    assert torch.equal(toks[..., 1:], labels[..., :-1])
    # each row follows its own client's table: make client 3's chain step
    # +1 and client 0's +2 deterministically
    v = pipe.v
    for client, step in ((3, 1), (0, 2)):
        nxt = (torch.arange(v) + step) % v
        pipe.cum[client] = (torch.arange(v)[None, :] >= nxt[:, None]).float()
    det = pipe.sample_batch([3, 0])
    for row, step in ((0, 1), (1, 2)):
        assert torch.equal(det["labels"][row], (det["tokens"][row] + step) % v)
    # the stream is reproducible from the seed
    again = pipeline.SyntheticTokenPipeline(dcfg, gemma2_2b.REDUCED, "cpu")
    assert torch.equal(again.sample_batch([3, 0])["tokens"], toks)
