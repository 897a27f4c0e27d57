"""Synthetic token data pipeline for LM training (no downloadable
corpora): a learnable Markov-chain token stream, so losses drop well below
the uniform-entropy floor iff the model learns. The port of
``repro.data.tokens``: the same numpy draws, so one seed gives the
reference's batches; only the container differs (int64 tensors, torch's
index type, on the pipeline's device)."""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticTokenPipeline:
    """Order-1 Markov stream with a skewed transition matrix + shift
    labels. ``device=None`` means the card."""

    def __init__(self, vocab: int = 512, seq_len: int = 128, batch: int = 8,
                 seed: int = 0, branching: int = 8,
                 device: Optional[Union[str, torch.device]] = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        # each token can transition to `branching` successors w/ Zipf weights
        self._succ = rng.integers(0, vocab, size=(vocab, branching))
        w = 1.0 / np.arange(1, branching + 1)
        self._w = w / w.sum()
        self._rng = rng

    def next_batch(self) -> Dict[str, torch.Tensor]:
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = self._rng.integers(0, self.vocab, self.batch)
        for t in range(self.seq_len):
            choice = self._rng.choice(self._succ.shape[1], size=self.batch,
                                      p=self._w)
            toks[:, t + 1] = self._succ[toks[:, t], choice]
        toks = torch.from_numpy(toks.astype(np.int64)).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
