"""Whether the timed path's outputs are right: the widest gap by which a
served token's logit lies below the plain reference's best.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the window served, the one with the
longest output always among them, is run through the reference
(``reference/lm.py``) over its prompt as the engine prefilled it (zero-padded
to ``prompt_len``) followed by its served tokens. At each served token the
reference's logits are read: the gap is the reference's best logit minus
the served token's. Greedy decoding serves the argmax of its own logits,
so a sound run reads rounding only; a wrong token reads a real gap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import lm


@dataclass
class Served:
    """What the check needs of one finished request."""
    seq: int                  # submission order
    prompt: np.ndarray        # int64 prompt ids
    output: np.ndarray        # served tokens


def sample(served: Sequence[Served], seed: int, min_tokens: int,
           max_rows: int) -> List[Served]:
    """The requests to run through the reference: the longest output
    first, then drawn from the seed until ``min_tokens`` served tokens are
    covered or ``max_rows`` requests taken."""
    if not served:
        return []
    rng = np.random.default_rng([seed, 1])
    longest = max(served, key=lambda s: (len(s.output), -s.seq))
    picked, n = [longest], len(longest.output)
    for i in rng.permutation(len(served)):
        s = served[int(i)]
        if n >= min_tokens or len(picked) >= max_rows:
            break
        if s is not longest:
            picked.append(s)
            n += len(s.output)
    return picked


def gaps(model: Dict, params: Dict, group: List[Served], prompt_len: int,
         quant: Optional[str] = None) -> torch.Tensor:
    """The gaps of the group's served tokens (N,), float32. With ``quant``
    the gap is that of the token the control's logits put first, in place
    of the served one."""
    dev = params["embed"]["table"].device
    n_out = max(len(s.output) for s in group)
    toks = np.zeros((len(group), prompt_len + n_out - 1), np.int64)
    for r, s in enumerate(group):
        toks[r, :len(s.prompt)] = s.prompt[:prompt_len]
        toks[r, prompt_len:prompt_len + len(s.output) - 1] = s.output[:-1]
    toks_t = torch.as_tensor(toks, device=dev)
    with torch.no_grad():
        h = lm.hidden(model, params, toks_t)
        sel_r = np.concatenate([np.full(len(s.output), r)
                                for r, s in enumerate(group)])
        sel_p = np.concatenate([prompt_len - 1 + np.arange(len(s.output))
                                for s in group])
        served = torch.as_tensor(np.concatenate([s.output for s in group]),
                                 device=dev)
        ref = lm.logits(model, params, h[sel_r, sel_p])
        if quant is None:
            pick = served
        else:
            hq = lm.hidden(model, params, toks_t, quant=quant)
            pick = lm.logits(model, params, hq[sel_r, sel_p],
                             quant=quant).argmax(-1)
        best = ref.max(-1).values
        return (best - ref.gather(1, pick[:, None])[:, 0]).cpu()


def widest_gap(model: Dict, params: Dict, group: List[Served],
               prompt_len: int, quant: Optional[str] = None
               ) -> Dict[str, float]:
    """{"max_logit_gap", "mean_logit_gap", "tokens_compared",
    "requests_compared"} over the group."""
    lm.set_precision()
    g = gaps(model, params, group, prompt_len, quant) if group \
        else torch.zeros(0)
    nan = float("nan")
    return {"max_logit_gap": float(g.max()) if len(g) else nan,
            "mean_logit_gap": float(g.mean()) if len(g) else nan,
            "tokens_compared": int(len(g)),
            "requests_compared": len(group)}


def judge(got: Dict, limits: Dict) -> Dict[str, Dict]:
    """Each number the cell's ``limits`` name, beside its limit: a gap must
    not exceed its limit, ``tokens_compared`` must reach its own."""
    out = {}
    for key, lim in limits.items():
        v = got[key]
        ok = v >= lim if key == "tokens_compared" else v <= lim
        out[key] = {"value": v, "limit": lim, "ok": bool(ok)}
    return out
