"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. With no
card present that default raises: the port never falls back to the CPU on
its own. Callers that want the CPU (the tests) ask for it explicitly. A
rank that a launcher started (``LOCAL_RANK`` set, as by ``torchrun``) takes
its own card, not every rank card 0.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (``cuda:<LOCAL_RANK>`` in a launched rank; raises
    without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if "LOCAL_RANK" in os.environ:
            return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
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


def use_float32_math() -> None:
    """Run float32 convolutions and matmuls in float32 on the card.

    PyTorch lets cuDNN (and, in some versions, cuBLAS) compute float32
    convolutions and matmuls in TF32, whose 10-bit mantissa moves the port's
    float32 outputs off the JAX package's by far more than float32 rounding
    (head maps ~1e-3 relative against 5e-5). The flags are process-wide, so
    the entry points that build or load a float32 model call this once, at
    build time, not around each forward: a context manager would race with
    the server's dispatcher threads. A caller that wants TF32 sets the flags
    back after building."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
