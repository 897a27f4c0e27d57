"""Weight bridge: the reference ``LM.init`` pytree -> the port's params;
the reference's LSTM forecaster params, its ``AdamState`` and its ResNet
params -> the port's trees (``lstm_params_from_jax``,
``adam_state_from_jax``, ``resnet_params_from_jax``).

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
from repro_torch.models.model import AUDIO_FRAME_DIM, VISION_EMBED_DIM
from repro_torch.models.resnet import resnet_shapes
from repro_torch.train.optimizer import AdamState

# Leaves kept in the param dtype: the reference uses them in fp32 whatever
# the compute dtype (norm weights; the SSM's conv taps and bias, decay and
# step parameters, skip and gated-norm weights; the hybrid's mix scales;
# the MoE router; the cross-attention's and the encoder's final norms).
# Every other leaf is a matrix, cast to the compute dtype before each
# product in the reference and stored in it here.
_PARAM_DTYPE_LEAVES = ("ln1", "ln2", "final_norm", "conv_w", "conv_b",
                       "A_log", "D_skip", "dt_bias", "norm_w", "mix_scale",
                       "router", "lnx", "enc_norm")


def expected_shapes(cfg: ModelConfig) -> Dict:
    """Nested dict of leaf shapes of ``LM.init`` for any family: the
    decoder ``layers`` (with ``xattn`` and ``lnx`` in the encoder-decoder
    family), the encoder's ``enc_layers``, ``enc_in`` and ``enc_norm``, the
    VLM's ``vis_proj``."""
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.padded_vocab
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    emb: Dict[str, Tuple] = {"table": (V, D)}
    if not cfg.tie_embeddings:
        emb["unembed"] = (D, V)

    def attn(n):
        return {"wq": (n, D, H * hd), "wk": (n, D, KV * hd),
                "wv": (n, D, KV * hd), "wo": (n, H * hd, D)}

    def mlp(n):
        ffn: Dict[str, Tuple] = {"wi": (n, D, F), "wo": (n, F, D)}
        if cfg.mlp_type in ("swiglu", "geglu"):
            ffn["wg"] = (n, D, F)
        return ffn

    layers: Dict = {"ln1": (L, D)}
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        layers["attn"] = attn(L)
    if cfg.family in ("ssm", "hybrid"):
        di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        ch = di + 2 * N
        layers["ssm"] = {"in_proj": (L, D, 2 * di + 2 * N + Hs),
                         "conv_w": (L, cfg.conv_width, ch), "conv_b": (L, ch),
                         "A_log": (L, Hs), "D_skip": (L, Hs),
                         "dt_bias": (L, Hs), "norm_w": (L, di),
                         "out_proj": (L, di, D)}
    if cfg.family == "hybrid":
        layers["mix_scale"] = (L, 2)
    if cfg.family == "moe":
        E = cfg.num_experts
        layers.update(ffn={"router": (L, D, E), "wi": (L, E, D, F),
                           "wg": (L, E, D, F), "wo": (L, E, F, D)},
                      ln2=(L, D))
    elif cfg.family in ("dense", "vlm", "audio", "hybrid"):
        layers.update(ffn=mlp(L), ln2=(L, D))
    tree = {"embed": emb, "final_norm": (D,), "layers": layers}
    if cfg.is_encoder_decoder:
        layers.update(xattn=attn(L), lnx=(L, D))
        Le = cfg.enc_layers
        tree.update(enc_layers={"ln1": (Le, D), "attn": attn(Le),
                                "ln2": (Le, D), "ffn": mlp(Le)},
                    enc_in=(AUDIO_FRAME_DIM, D), enc_norm=(D,))
    if cfg.frontend == "vision_patches":
        tree["vis_proj"] = (VISION_EMBED_DIM, D)
    return tree


def _copy_tree(tree: Mapping, want: Dict, device, dtype_of) -> Dict:
    """``tree``'s arrays as tensors on ``device``, each leaf in
    ``dtype_of(its dotted path)``, checked key for key and shape for shape
    against ``want`` (nested dicts of shapes): a missing or extra leaf, or
    a wrong shape, raises."""
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
        return torch.tensor(arr, dtype=torch.float32).to(
            device=device, dtype=dtype_of(path))

    return walk(tree, want, "")


def params_from_jax(tree: Mapping, cfg: ModelConfig, device,
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """Copy a reference params pytree onto ``device``. Matrices are stored
    in ``dtype`` (default: the config's compute dtype), the leaves the
    reference uses in fp32 (``_PARAM_DTYPE_LEAVES``) in the config's param
    dtype — the port's ``LM.init`` storage."""
    wdt = dtype or torch_dtype(cfg.dtype)
    ndt = torch_dtype(cfg.param_dtype)
    return _copy_tree(tree, expected_shapes(cfg), device, lambda path: (
        ndt if path.split(".")[-1] in _PARAM_DTYPE_LEAVES else wdt))


LSTM_SHAPES = ("wx", "wh", "b", "dense_w", "dense_b")


def tree_from_numpy(tree, device):
    """A nested dict of arrays -> the same dict of tensors on ``device``,
    each array's dtype kept (copies)."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.array(tree)).to(device)


def lstm_params_from_jax(tree: Mapping, device) -> Dict:
    """The reference's ``lstm_init`` params -> the port's (fp32 tensors,
    the same keys)."""
    if set(tree) != set(LSTM_SHAPES):
        raise ValueError(f"LSTM params: keys {sorted(tree)}, expected "
                         f"{sorted(LSTM_SHAPES)}")
    return {k: torch.tensor(np.asarray(tree[k]), dtype=torch.float32,
                            device=device) for k in LSTM_SHAPES}


def adam_state_from_jax(state, device):
    """The reference's ``AdamState`` (a NamedTuple of ``step``, ``mu``,
    ``nu``) -> the port's: ``step`` an int32 0-d tensor, the moments
    trees of fp32 tensors with the same keys."""
    return AdamState(step=torch.tensor(int(np.asarray(state.step)),
                                       dtype=torch.int32, device=device),
                     mu=tree_from_numpy(state.mu, device),
                     nu=tree_from_numpy(state.nu, device))


def resnet_params_from_jax(tree: Mapping, name: str, device,
                           num_classes: int = 1000) -> Dict:
    """The reference's ``init_resnet`` params -> the port's: fp32 tensors
    with the same keys and layouts (convolutions HWIO, the head (C, classes)).
    A missing or extra key, or a wrong shape, raises."""
    return _copy_tree(tree, resnet_shapes(name, num_classes), device,
                      lambda path: torch.float32)
