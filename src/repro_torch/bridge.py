"""Weight bridge: the reference ``LM.init`` pytree -> the port's params.

The reference draws its weights from ``jax.random``; tests hand those same
numbers (as numpy arrays, the pytree's keys unchanged) to the port, so
both packages run identical weights. Layers stay stacked and every leaf
maps one to one: a missing or extra leaf, or a wrong shape, raises.
Leaves are copied (``np.asarray`` of a JAX array is read-only, and a view
would tie the port's tensors to the reference's buffers).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype

_NORMS = ("ln1", "ln2", "final_norm")


def expected_shapes(cfg: ModelConfig) -> Dict:
    """Nested dict of leaf shapes of a dense-family ``LM.init``."""
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.padded_vocab
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    emb: Dict[str, Tuple] = {"table": (V, D)}
    if not cfg.tie_embeddings:
        emb["unembed"] = (D, V)
    ffn: Dict[str, Tuple] = {"wi": (L, D, F), "wo": (L, F, D)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        ffn["wg"] = (L, D, F)
    return {"embed": emb, "final_norm": (D,),
            "layers": {"ln1": (L, D), "ln2": (L, D), "ffn": ffn,
                       "attn": {"wq": (L, D, H * hd), "wk": (L, D, KV * hd),
                                "wv": (L, D, KV * hd), "wo": (L, H * hd, D)}}}


def params_from_jax(tree: Mapping, cfg: ModelConfig, device,
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """Copy a reference params pytree onto ``device``. Matrices are stored
    in ``dtype`` (default: the config's compute dtype), norm weights in the
    config's param dtype — the port's ``LM.init`` storage."""
    wdt = dtype or torch_dtype(cfg.dtype)
    ndt = torch_dtype(cfg.param_dtype)

    def walk(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, Mapping):
                raise ValueError(f"{path or 'params'}: expected a dict")
            missing, extra = set(want) - set(node), set(node) - set(want)
            if missing or extra:
                raise ValueError(f"{path or 'params'}: missing leaves "
                                 f"{sorted(missing)}, extra {sorted(extra)}")
            return {k: walk(node[k], want[k], f"{path}.{k}".lstrip("."))
                    for k in want}
        arr = np.asarray(node)
        if arr.shape != want:
            raise ValueError(f"{path}: shape {arr.shape}, expected {want}")
        leaf_dt = ndt if path.split(".")[-1] in _NORMS else wdt
        return torch.tensor(arr, dtype=torch.float32).to(device=device,
                                                         dtype=leaf_dt)

    return walk(tree, expected_shapes(cfg), "")
