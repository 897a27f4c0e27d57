"""The weights of one run, made on the device from the seed.

One draw a stacked leaf, in the dtype it is served in: normal, scaled by
1/sqrt(fan_in) of the product it feeds (the router and every expert matrix
too), the embedding table at unit scale, the norm gains drawn round 1
(the port stores a gain g as g - 1). The same tensors go to the engine
(``InProcessServingEngine(weights=...)``) and to the plain reference, which
reads them only as inputs.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def make_params(model: Dict, seed: int, device) -> Dict:
    """``model``: the ``model`` group of a configuration file. Returns the
    port's parameter tree (stacked layer leaves)."""
    dev = torch.device(device)
    dt = getattr(torch, model["dtype"])
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    L, D = model["num_layers"], model["d_model"]
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    F = model["d_ff"]
    V = model["vocab_size"]
    Vp = (V + 255) // 256 * 256
    def s(n):
        return 1.0 / math.sqrt(n)
    layers: Dict = {
        "ln1": _normal(gen, (L, D), 0.1, f32, dev),
        "ln2": _normal(gen, (L, D), 0.1, f32, dev),
        "attn": {"wq": _normal(gen, (L, D, H * hd), s(D), dt, dev),
                 "wk": _normal(gen, (L, D, KV * hd), s(D), dt, dev),
                 "wv": _normal(gen, (L, D, KV * hd), s(D), dt, dev),
                 "wo": _normal(gen, (L, H * hd, D), s(H * hd), dt, dev)}}
    E = model.get("num_experts", 0)
    if E:
        layers["ffn"] = {"router": _normal(gen, (L, D, E), s(D), f32, dev),
                         "wi": _normal(gen, (L, E, D, F), s(D), dt, dev),
                         "wg": _normal(gen, (L, E, D, F), s(D), dt, dev),
                         "wo": _normal(gen, (L, E, F, D), s(F), dt, dev)}
    else:
        layers["ffn"] = {"wi": _normal(gen, (L, D, F), s(D), dt, dev),
                         "wg": _normal(gen, (L, D, F), s(D), dt, dev),
                         "wo": _normal(gen, (L, F, D), s(F), dt, dev)}
    return {"embed": {"table": _normal(gen, (Vp, D), 1.0, dt, dev),
                      "unembed": _normal(gen, (D, Vp), s(D), dt, dev)},
            "final_norm": _normal(gen, (D,), 0.1, f32, dev),
            "layers": layers}
