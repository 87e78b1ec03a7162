"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. With no
card present that default raises: the port never falls back to the CPU on
its own. Callers that want the CPU (the tests) ask for it explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """Config dtype string ('bfloat16', 'float32', ...) -> torch dtype."""
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float16": torch.float16}
    key = str(name or "float32")
    if key not in table:
        raise ValueError(f"unsupported dtype {name!r}; expected one of {sorted(table)}")
    return table[key]
