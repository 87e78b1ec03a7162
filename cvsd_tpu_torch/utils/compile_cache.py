"""Opt-in persistent compile cache (the port's ``cvsd_tpu/utils/compile_cache.py``).

The JAX package caches XLA executables across processes. The port never
calls ``torch.compile``; what it compiles are its CUDA kernels, which
``utils/cuda_build.py`` builds with ``nvcc`` into shared libraries named by
a hash of their sources, headers and flags, and loads again without
compiling wherever the hashed library exists. By default they live under
the package (``csrc/build/``). ``CVSD_COMPILE_CACHE_DIR`` (or ``path``)
moves that build directory: for a read-only install, or a cache that
several checkouts or processes share, so a fresh process launches its first
kernel without running ``nvcc``.

Strictly opt-in, idempotent, and safe to call from every CLI at import
(``cli/common.py`` does). A library is loaded only under its own hash, so
a shared directory never hands a process a stale kernel.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Optional

_ENV = "CVSD_COMPILE_CACHE_DIR"
_enabled_path: Optional[str] = None


def maybe_enable_compile_cache(path: Optional[str] = None) -> bool:
    """Build and load the CUDA kernels under ``path`` (or
    $CVSD_COMPILE_CACHE_DIR). Returns True when a cache directory is in
    use. A second call with another path keeps the first and warns."""
    global _enabled_path
    target = path or os.environ.get(_ENV)
    if not target:
        return False
    if _enabled_path is not None:
        if path and path != _enabled_path:
            warnings.warn(f"compile cache already enabled at {_enabled_path!r}; "
                          f"ignoring new path {path!r}", stacklevel=2)
        return True
    from cvsd_tpu_torch.utils import cuda_build

    os.makedirs(target, exist_ok=True)
    cuda_build.BUILD_DIR = Path(target).resolve()
    _enabled_path = target
    return True
