"""ResNet variant family (the paper's own backends: ResNet-18/34/50/101/152):
the port of ``repro.models.resnet``.

The reference's signature and layouts are kept: params hold convolutions
in HWIO and the head as (C, classes), inputs are NHWC (B, H, W, 3), the
output is logits (B, classes). ``apply_resnet`` converts once inside: the
input to NCHW (a view), each kernel to OIHW. BatchNorm is folded into
inference-mode scale/shift (``x * scale + shift``), as serving systems run
frozen BN.

Convolutions are ``F.conv2d`` (cuDNN on the card) and the stem's pooling
``F.max_pool2d``: the reference computes them with
``lax.conv_general_dilated`` and ``reduce_window``, outside any Pallas
kernel. ``"SAME"`` padding is asymmetric at stride 2 (low pad total // 2,
high pad the rest: the 7x7 stride-2 stem at 224 pads (2, 3), a 3x3
stride-2 convolution at 56 pads (0, 1)), where ``padding=`` of PyTorch is
symmetric and would shift the window: every layer pads explicitly with
``F.pad`` (the pool with -inf) and then runs unpadded.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

# (block type, layers-per-stage, ImageNet top-1 accuracy %, readiness time s)
RESNET_SPECS: Dict[str, Tuple[str, List[int], float, float]] = {
    "resnet18": ("basic", [2, 2, 2, 2], 69.76, 4.0),
    "resnet34": ("basic", [3, 4, 6, 3], 73.31, 6.0),
    "resnet50": ("bottleneck", [3, 4, 6, 3], 76.13, 8.0),
    "resnet101": ("bottleneck", [3, 4, 23, 3], 77.37, 12.0),
    "resnet152": ("bottleneck", [3, 8, 36, 3], 78.31, 15.0),
}
STAGE_WIDTHS = [64, 128, 256, 512]


def _blocks(name: str):
    """(stage, block, stride, cin, width, cout) of every residual block."""
    block, stages, _, _ = RESNET_SPECS[name]
    expansion = 1 if block == "basic" else 4
    cin = 64
    for si, (n_blocks, width) in enumerate(zip(stages, STAGE_WIDTHS)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            cout = width * expansion
            yield si, bi, stride, cin, width, cout
            cin = cout


def resnet_shapes(name: str, num_classes: int = 1000) -> Dict:
    """The params tree of ``init_resnet`` as shapes, key for key."""
    block = RESNET_SPECS[name][0]
    tree: Dict = {"stem": (7, 7, 3, 64), "stem_scale": (64,),
                  "stem_shift": (64,)}
    cout = 64
    for si, bi, stride, cin, width, cout in _blocks(name):
        if block == "basic":
            convs = {"c1": (3, 3, cin, width), "c2": (3, 3, width, cout)}
        else:
            convs = {"c1": (1, 1, cin, width), "c2": (3, 3, width, width),
                     "c3": (1, 1, width, cout)}
        if stride != 1 or cin != cout:
            convs["proj"] = (1, 1, cin, cout)
        bp: Dict = {}
        for nm, shape in convs.items():
            bp.update({nm: shape, nm + "_scale": (shape[-1],),
                       nm + "_shift": (shape[-1],)})
        tree[f"s{si}b{bi}"] = bp
    tree["head"] = (cout, num_classes)
    return tree


def init_resnet(gen: torch.Generator, name: str, num_classes: int = 1000
                ) -> Dict:
    """Params on ``gen.device`` drawn from ``gen`` with the reference's
    distributions: convolutions He-normal (σ = √(2 / (kh·kw·cin))), BN
    scale 1 and shift 0, the head normal × 0.01; fp32, HWIO."""
    dev = gen.device

    def draw(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def init(shapes):
        out = {}
        for k, shape in shapes.items():
            if isinstance(shape, dict):
                out[k] = init(shape)
            elif k.endswith("_scale"):
                out[k] = torch.ones(shape, device=dev)
            elif k.endswith("_shift"):
                out[k] = torch.zeros(shape, device=dev)
            elif k == "head":
                out[k] = draw(shape, 0.01)
            else:
                out[k] = draw(shape, math.sqrt(2.0 / math.prod(shape[:3])))
        return out

    return init(resnet_shapes(name, num_classes))


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of ``"SAME"`` along one axis of size n."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    """x (B, C, H, W) padded as ``"SAME"`` pads it for a k x k window."""
    top, bottom = _same_pads(x.shape[2], k, stride)
    left, right = _same_pads(x.shape[3], k, stride)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, C, H, W), w HWIO -> ``"SAME"`` convolution (B, O, H', W')."""
    k = w.shape[0]
    return F.conv2d(_pad_same(x, k, stride), w.permute(3, 2, 0, 1),
                    stride=stride)


def _bn(x: torch.Tensor, scale: torch.Tensor,
        shift: torch.Tensor) -> torch.Tensor:
    return x * scale[:, None, None] + shift[:, None, None]


def apply_resnet(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) -> logits (B, num_classes)."""
    block = RESNET_SPECS[name][0]
    h = x.permute(0, 3, 1, 2)                              # NHWC -> NCHW
    h = torch.relu(_bn(_conv(h, p["stem"], 2), p["stem_scale"],
                       p["stem_shift"]))
    h = F.max_pool2d(_pad_same(h, 3, 2, float("-inf")), 3, 2)
    for si, bi, stride, _, _, _ in _blocks(name):
        bp = p[f"s{si}b{bi}"]
        r = h
        if block == "basic":
            y = torch.relu(_bn(_conv(h, bp["c1"], stride), bp["c1_scale"],
                               bp["c1_shift"]))
            y = _bn(_conv(y, bp["c2"], 1), bp["c2_scale"], bp["c2_shift"])
        else:
            y = torch.relu(_bn(_conv(h, bp["c1"], 1), bp["c1_scale"],
                               bp["c1_shift"]))
            y = torch.relu(_bn(_conv(y, bp["c2"], stride), bp["c2_scale"],
                               bp["c2_shift"]))
            y = _bn(_conv(y, bp["c3"], 1), bp["c3_scale"], bp["c3_shift"])
        if "proj" in bp:
            r = _bn(_conv(r, bp["proj"], stride), bp["proj_scale"],
                    bp["proj_shift"])
        h = torch.relu(y + r)
    return h.mean(dim=(2, 3)) @ p["head"]


def resnet_flops(name: str, image: int = 224) -> float:
    """Analytic forward GFLOPs (for profile calibration sanity checks)."""
    known = {"resnet18": 1.82, "resnet34": 3.68, "resnet50": 4.12,
             "resnet101": 7.85, "resnet152": 11.58}
    return known[name] * 1e9 * (image / 224) ** 2
