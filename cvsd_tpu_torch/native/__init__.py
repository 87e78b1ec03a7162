"""ctypes bindings for the port's C++ host runtime (``csrc/host/``; the
port's copy of ``cvsd_tpu/native/__init__.py``).

- ``NativeCsvWriter``: buffered BBox CSV emitter whose float formatting
  equals Python's ``repr`` byte for byte (``csrc/host/csv_writer.cpp``)
- ``NativeRingBuffer``: fixed-slot producer/consumer frame staging buffer
  (``csrc/host/ring_buffer.cpp``)

The library is built with the host compiler at first use
(``utils/host_build.py``; never at import). Every consumer has a pure-Python
path, and chooses as the reference does: unset, native exactly when the
library builds (``available()``); ``True`` builds it or raises naming the
compiler (``load(required=True)``). A failed build that nobody asked for
explicitly warns once with the compiler's log and falls back.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from typing import Callable, Optional

import numpy as np

_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    # csv writer
    lib.csvw_open.restype = ctypes.c_void_p
    lib.csvw_open.argtypes = [ctypes.c_char_p]
    lib.csvw_write_bboxes.restype = ctypes.c_int
    lib.csvw_write_bboxes.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_char_p,
    ]
    lib.csvw_flush.argtypes = [ctypes.c_void_p]
    lib.csvw_close.argtypes = [ctypes.c_void_p]
    # ring buffer
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int, ctypes.c_long]
    lib.rb_slot_ptr.restype = ctypes.POINTER(ctypes.c_char)
    lib.rb_slot_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rb_acquire_write.restype = ctypes.c_int
    lib.rb_acquire_write.argtypes = [ctypes.c_void_p]
    lib.rb_commit_write.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rb_acquire_read.restype = ctypes.c_int
    lib.rb_acquire_read.argtypes = [ctypes.c_void_p]
    lib.rb_release_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rb_close.argtypes = [ctypes.c_void_p]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]


def load_library(build: Callable[[], "os.PathLike[str]"], bind: Callable[[ctypes.CDLL], None],
                 what: str, state: dict, required: bool) -> Optional[ctypes.CDLL]:
    """The build-once logic both native libraries share. ``state`` holds
    the loaded 'lib', the build's 'failure' text, and whether it 'warned';
    the caller holds its lock. A failure marked ``quiet`` (the decoder's
    missing OpenCV development files, which the reference's Makefile skips
    in silence too) falls back without a warning."""
    from cvsd_tpu_torch.utils.host_build import BuildError

    if state["lib"] is not None:
        return state["lib"]
    if state["failure"] is None:
        try:
            lib = ctypes.CDLL(str(build()))
            bind(lib)
            state["lib"] = lib
            return lib
        except (BuildError, OSError, AttributeError) as e:
            state["failure"] = str(e)
            state["warned"] = bool(getattr(e, "quiet", False))
    if required:
        raise RuntimeError(f"{what} was requested but is unavailable: {state['failure']}")
    if not state["warned"]:
        state["warned"] = True
        warnings.warn(f"{what} is unavailable; the Python path runs instead:\n"
                      f"{state['failure']}", RuntimeWarning, stacklevel=3)
    return None


_state = {"lib": None, "failure": None, "warned": False}


def load(required: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building at first use) the CSV writer and ring buffer library;
    None when it cannot be built, or raise where ``required``."""
    from cvsd_tpu_torch.utils import host_build

    with _lock:
        return load_library(host_build.build_native, _bind,
                            "the native host runtime (CSV writer, ring buffer)",
                            _state, required)


def available() -> bool:
    return load() is not None


def resolve(flag: Optional[bool], probe: Callable[[], bool],
            require: Callable[[], object]) -> bool:
    """The selection rule of every native part: ``None`` -> ``probe()``
    (native exactly when it builds); ``True`` -> ``require()`` (builds or
    raises); ``False`` -> the Python path."""
    if flag is None:
        return probe()
    if flag:
        require()
        return True
    return False


def use_native_ring(flag: Optional[bool]) -> bool:
    """``use_native_ring`` -> whether to stage frames in the native ring:
    unset, exactly when the library builds; ``True`` builds it or raises."""
    return resolve(flag, available, lambda: load(required=True))


class NativeCsvWriter:
    """Buffered append-mode BBox CSV writer (one handle per output file)."""

    def __init__(self, path: str):
        lib = load(required=True)
        self._lib = lib
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._h = lib.csvw_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write_video_rows(self, clip: int, name: str, frames: np.ndarray,
                         persons: np.ndarray, ltwh: np.ndarray,
                         is_anomaly: bool, anomaly: str) -> int:
        """Append n rows sharing (clip, name, is_anomaly, anomaly)."""
        frames = np.ascontiguousarray(frames, np.int32)
        persons = np.ascontiguousarray(persons, np.float64)
        ltwh = np.ascontiguousarray(ltwh, np.float64)
        n = int(frames.shape[0])
        if persons.shape != (n,) or ltwh.shape != (n, 4):
            raise ValueError(f"{n} frames need persons ({n},) and ltwh ({n}, 4), got "
                             f"{persons.shape} and {ltwh.shape}")
        return self._lib.csvw_write_bboxes(
            self._h, n, int(clip), name.encode(),
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            persons.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ltwh.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            int(bool(is_anomaly)), anomaly.encode(),
        )

    def flush(self) -> None:
        self._lib.csvw_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.csvw_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeRingBuffer:
    """Fixed-slot staging buffer; slots exposed as zero-copy numpy arrays."""

    def __init__(self, slots: int, shape: tuple, dtype=np.uint8):
        lib = load(required=True)
        self._lib = lib
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.slot_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self._h = lib.rb_create(int(slots), self.slot_bytes)
        self._views = {}
        for s in range(slots):
            ptr = lib.rb_slot_ptr(self._h, s)
            buf = (ctypes.c_char * self.slot_bytes).from_address(
                ctypes.cast(ptr, ctypes.c_void_p).value
            )
            self._views[s] = np.frombuffer(buf, dtype=self.dtype).reshape(self.shape)

    def slot(self, idx: int) -> np.ndarray:
        return self._views[idx]

    def acquire_write(self) -> int:
        return self._lib.rb_acquire_write(self._h)

    def commit_write(self, idx: int) -> None:
        self._lib.rb_commit_write(self._h, idx)

    def acquire_read(self) -> int:
        return self._lib.rb_acquire_read(self._h)

    def release_read(self, idx: int) -> None:
        self._lib.rb_release_read(self._h, idx)

    def close(self) -> None:
        self._lib.rb_close(self._h)

    def destroy(self) -> None:
        if self._h:
            self._lib.rb_destroy(self._h)
            self._h = None
