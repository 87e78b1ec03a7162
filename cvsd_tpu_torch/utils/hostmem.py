"""Host allocator hygiene for long-running streaming processes.

The port's own copy of ``cvsd_tpu/utils/hostmem.py``. The streaming loop's
per-batch churn (decode buffers, letterbox canvases) interleaves long- and
short-lived chunks, so glibc's main arena keeps a ratcheting high-water mark
of FREED memory. malloc_trim(0) releases whole free pages back to the kernel;
it is a no-op on non-glibc platforms (the symbol simply isn't there).

Opt-out via CVSD_DISABLE_MALLOC_TRIM=1.
"""

from __future__ import annotations

import ctypes
import os

_trim = None
_checked = False


def malloc_trim() -> bool:
    """Release glibc arena free pages to the OS. Returns True if trimmed."""
    global _trim, _checked
    if os.environ.get("CVSD_DISABLE_MALLOC_TRIM"):
        return False
    if not _checked:
        _checked = True
        try:
            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            _trim = libc.malloc_trim
            _trim.argtypes = [ctypes.c_size_t]
            _trim.restype = ctypes.c_int
        except (OSError, AttributeError):
            _trim = None
    if _trim is None:
        return False
    try:
        _trim(0)
        return True
    except Exception:
        return False


_last_trim = 0.0


def maybe_malloc_trim(min_interval_s: float = 10.0) -> bool:
    """Time-gated malloc_trim for hot paths (serving dispatch loops): trims
    at most once per `min_interval_s` so the ~0.1-1 ms cost never shows up
    in per-request latency budgets."""
    global _last_trim
    import time

    now = time.monotonic()
    if now - _last_trim < min_interval_s:
        return False
    if malloc_trim():
        _last_trim = now
        return True
    return False
