"""Faults planted under the timed path, to show that ``correct`` catches
them: each is a context manager that patches the program while it is open.
One card serves each cell, so no exchange between cards can be left out.

    with planted("token-altered"):
        harness.run(...)
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Tuple


def _stale_step() -> Tuple[object, str, Callable]:
    """A decode step that returns its state unchanged: the cache is not
    written and the position does not advance."""
    from repro_torch.models.model import LM
    real = LM.decode_step

    def step(self, params, cache, tokens):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, _ = real(self, params, cache, tokens)
        for k, v in saved.items():
            cache[k].copy_(v)
        return logits, cache
    return LM, "decode_step", step


def _half_batch() -> Tuple[object, str, Callable]:
    """Half of the batch left out: of the requests a prefill call admits
    together (its rows that hold a prompt, first in the call), the later
    half prefill zeros in place of their prompts."""
    import torch
    from repro_torch.serving.engine import VariantBackend
    real = VariantBackend._prefill_step

    def prefill(self, tokens):
        n = (tokens != 0).any(dim=1).sum()
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        return real(self, tokens * (rows < (n + 1) // 2)[:, None])
    return VariantBackend, "_prefill_step", prefill


def _altered_token() -> Tuple[object, str, Callable]:
    """A served token altered where it is produced."""
    from repro_torch.serving.engine import VariantBackend
    real = VariantBackend._finish

    def finish(self, r, tokens, now):
        tokens = list(tokens)
        tokens[len(tokens) // 2] = (tokens[len(tokens) // 2] + 1) \
            % self.cfg.vocab_size
        real(self, r, tokens, now)
    return VariantBackend, "_finish", finish


FAULTS: Dict[str, Callable[[], Tuple[object, str, Callable]]] = {
    "state-unchanged": _stale_step,
    "half-batch": _half_batch,
    "token-altered": _altered_token,
}


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    """The program with the fault ``name`` planted, while open."""
    owner, attr, broken = FAULTS[name]()
    real = owner.__dict__[attr]
    setattr(owner, attr, broken)
    try:
        yield
    finally:
        setattr(owner, attr, real)
