"""Deterministic, restart-safe LM token pipelines: the port's own copy of
`repro.data.tokens` (the port imports nothing of the JAX package), whose
batches are byte-identical to the reference's.

A batch is a pure function of (seed, step, dp_rank): no iterator state to
checkpoint, any rank can rebuild any batch after preemption, and changing
dp_size only re-partitions the same global stream. The synthetic stream
has learnable structure (affine token recurrences with per-sequence
parameters, plus noise), so trainers show real loss curves.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05          # fraction of tokens replaced with noise
    dp_rank: int = 0
    dp_size: int = 1


class TokenPipeline:
    """Stateless synthetic next-token stream."""

    def __init__(self, cfg: TokenPipelineConfig):
        if cfg.global_batch % cfg.dp_size:
            raise ValueError('global_batch must divide by dp_size')
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.dp_size

    def _sequence(self, rng: np.random.Generator, s: int,
                  vocab: int) -> np.ndarray:
        # affine recurrence t_{k+1} = (a * t_k + b) mod vocab, per-sequence
        # (a, b) drawn from a small family => learnable with enough capacity.
        a = int(rng.choice([1, 3, 5, 7]))
        b = int(rng.integers(1, 17))
        t0 = int(rng.integers(0, vocab))
        toks = np.empty(s + 1, np.int64)
        toks[0] = t0
        for k in range(s):
            toks[k + 1] = (a * toks[k] + b) % vocab
        noise_mask = rng.random(s + 1) < self.cfg.noise
        toks[noise_mask] = rng.integers(0, vocab, noise_mask.sum())
        return toks

    def batch(self, step: int) -> dict:
        """Local shard of the global batch at `step` (tokens + targets)."""
        c = self.cfg
        out_t = np.empty((self.local_batch, c.seq_len), np.int32)
        out_y = np.empty((self.local_batch, c.seq_len), np.int32)
        for i in range(self.local_batch):
            gidx = step * c.global_batch + c.dp_rank * self.local_batch + i
            rng = np.random.default_rng((c.seed, gidx))
            seq = self._sequence(rng, c.seq_len, c.vocab)
            out_t[i] = seq[:-1]
            out_y[i] = seq[1:]
        return {'tokens': out_t, 'targets': out_y}


class RewardPipeline:
    """Stateless reward-model batches: token sequences with scalar utilities.

    The hidden utility of a sequence is a fixed random projection of its
    token histogram (plus optional group nuisance offsets), so a trained
    score head can actually rank them — the LM-framework integration of the
    paper's loss trains against these with the linearithmic pairwise hinge.
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_groups: int = 0, dp_rank: int = 0,
                 dp_size: int = 1):
        self.vocab, self.seq_len = vocab, seq_len
        self.global_batch, self.seed = global_batch, seed
        self.n_groups = n_groups
        self.dp_rank, self.dp_size = dp_rank, dp_size
        self.local_batch = global_batch // dp_size
        master = np.random.default_rng((seed, 0xBEAD))
        self._w_hist = master.normal(size=vocab) / np.sqrt(vocab)
        self._group_bias = (master.normal(scale=3.0, size=max(n_groups, 1))
                            if n_groups else None)

    def batch(self, step: int) -> dict:
        out_t = np.empty((self.local_batch, self.seq_len), np.int32)
        util = np.empty(self.local_batch, np.float32)
        grp = np.zeros(self.local_batch, np.int32)
        for i in range(self.local_batch):
            gidx = (step * self.global_batch
                    + self.dp_rank * self.local_batch + i)
            rng = np.random.default_rng((self.seed, 1, gidx))
            toks = rng.integers(0, self.vocab, self.seq_len)
            out_t[i] = toks
            hist = np.bincount(toks, minlength=self.vocab) / self.seq_len
            u = float(hist @ self._w_hist) * np.sqrt(self.seq_len)
            if self.n_groups:
                g = int(rng.integers(0, self.n_groups))
                grp[i] = g
                u += float(self._group_bias[g])  # nuisance: within-group only
            util[i] = u
        out = {'tokens': out_t, 'utilities': util}
        if self.n_groups:
            out['groups'] = grp
        return out


def frontend_inputs(cfg, batch: int, seed: int):
    """inputs(step, tokens) -> the model's inputs (numpy) for a (batch, S)
    numpy batch of the token stream, the reference's frontend stubs
    (`repro.launch.train`): an audio model takes frames looked up in a
    fixed seeded codebook in place of the tokens (it predicts the token
    ids), a vision model `frontend_tokens` image embeddings drawn from
    (seed, step) before them; any other model the tokens."""
    if cfg.frontend == 'audio':
        cb = (np.random.default_rng(7).normal(size=(cfg.vocab, cfg.d_model))
              .astype(np.float32) * 0.1)
        return lambda step, tokens: {'frame_embeds': cb[tokens]}
    if cfg.frontend == 'vision':
        def inputs(step, tokens):
            rng = np.random.default_rng((seed, step))
            img = rng.normal(size=(batch, cfg.frontend_tokens, cfg.d_model)
                             ).astype(np.float32)
            return {'tokens': tokens, 'image_embeds': img}
        return inputs
    return lambda step, tokens: {'tokens': tokens}
