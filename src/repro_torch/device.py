"""Device and dtype resolution shared by the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU: with no
card and no explicit ``device="cpu"`` they raise instead of carrying on
silently on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]
