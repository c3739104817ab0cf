"""Synthetic per-client token streams (``repro.data.pipeline``).

Each client's tokens come from its own Markov chain over a small vocab, so
clients see heterogeneous data and the loss can go down.  The transition
tables are the reference's, built on the host from the same numpy draws
(``SyntheticTokenPipeline.__init__``), so they agree bitwise.  Sampling
runs on the device: the chains advance by ``torch.searchsorted`` over the
cumulative tables, with every draw taken from one ``torch.Generator`` on
the device seeded with ``DataConfig.seed``.  Unlike the reference's
per-client threefry streams, the draws depend on the cohort's make-up.
A model with a stub frontend (``prefix_len``) also gets f32 normal
``prefix_embeds`` from the same generator, cast to its compute dtype, and
the encoder-decoder its f32 normal ``frames`` likewise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, upload
from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 256
    per_client_batch: int = 4
    vocab: int = 512
    seed: int = 0
    heterogeneity: float = 1.0  # 0 = iid clients, 1 = fully distinct chains
    n_clients: Optional[int] = None  # default 1


def transition_tables(dcfg: DataConfig, model_cfg: ModelConfig
                      ) -> np.ndarray:
    """``(n, v, v)`` f64 per-client bigram transition tables: per-client
    logits interpolated toward a shared table by ``1 - heterogeneity``.
    Both tables are drawn in single sequential fills, so client i's table
    depends only on ``(seed, i)``, never on n."""
    n = dcfg.n_clients or 1
    rng = np.random.default_rng(dcfg.seed)
    v = min(dcfg.vocab, model_cfg.vocab)
    shared = rng.normal(size=(v, v)) * 2.0
    per = rng.normal(size=(n, v, v)) * 2.0
    mix = dcfg.heterogeneity
    logits = mix * per + (1 - mix) * shared[None]
    z = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return (z / z.sum(axis=-1, keepdims=True)).astype(np.float64)


class SyntheticTokenPipeline:
    """Batches ``{"tokens", "labels"}`` of shape ``(c, b, seq_len)`` for a
    cohort of ``c`` clients, sampled on ``device``, ``prefix_embeds (c, b,
    prefix_len, d_model)`` when the model has a prefix and ``frames (c, b,
    n_frames, d_model)`` for the encoder-decoder."""

    def __init__(self, dcfg: DataConfig, model_cfg: ModelConfig,
                 device: DeviceLike = "cuda"):
        self.dcfg = dcfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.trans = transition_tables(dcfg, model_cfg)
        self.n, self.v = self.trans.shape[0], self.trans.shape[-1]
        self.cum = torch.from_numpy(
            np.cumsum(self.trans, axis=-1).astype(np.float32)
        ).to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(dcfg.seed)

    def sample_batch(self, clients: Sequence[int]) -> Dict[str, torch.Tensor]:
        """One batch for ``clients`` (row ``a`` is client ``clients[a]``'s
        chain): ``seq_len + 1`` states per sequence, tokens the first
        ``seq_len``, labels the last ``seq_len``; then the prefix
        embeddings or the frames, drawn after the tokens."""
        dev, g, v = self.device, self.generator, self.v
        b, T = self.dcfg.per_client_batch, self.dcfg.seq_len
        ids = upload(list(clients), dev, torch.long)[:, None]
        state = torch.randint(0, v, (ids.shape[0], b), generator=g,
                              device=dev)
        seq = [state]
        for _ in range(T):
            u = torch.rand((ids.shape[0], b, 1), generator=g, device=dev)
            rows = self.cum[ids, state]  # (c, b, v) cumulative rows
            state = torch.searchsorted(rows, u, right=True)[..., 0]
            state = state.clamp_(max=v - 1)
            seq.append(state)
        toks = torch.stack(seq, dim=-1)  # (c, b, T + 1)
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        mc = self.model_cfg
        if mc.prefix_len:
            pe = torch.randn((ids.shape[0], b, mc.prefix_len, mc.d_model),
                             generator=g, dtype=torch.float32, device=dev)
            batch["prefix_embeds"] = pe.to(mc.dtype)
        if mc.family == "encdec":
            fr = torch.randn((ids.shape[0], b, mc.n_frames, mc.d_model),
                             generator=g, dtype=torch.float32, device=dev)
            batch["frames"] = fr.to(mc.dtype)
        return batch
