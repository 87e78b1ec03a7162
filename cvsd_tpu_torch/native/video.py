"""ctypes binding for the port's native multi-stream video decoder
(``csrc/host/video_decode.cpp``; the port's copy of
``cvsd_tpu/native/video.py``). It builds only where OpenCV's C++
development files answer ``pkg-config opencv4``, as the reference Makefile
builds it; ``video_available()`` reports whether it is in.

One ``MultiStreamDecoder.next_batch()`` call decodes, resizes and
colour-converts a whole detector batch round-robin across many videos in
C++ (the GIL released for the whole call), in place of the per-frame Python
loop of ``pipeline/streaming.py::RoundRobinReader`` and
``pipeline/preprocess.py``. Its frames and frame numbers equal the Python
readers'. Its stamps are OpenCV's ``CAP_PROP_POS_MSEC`` as the system
OpenCV reports it, which on some hosts is 0.0 after the first frames (the
reference's decoder does the same).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from cvsd_tpu_torch.native import load_library

MODE_RAW, MODE_CONTENT, MODE_CANVAS = 0, 1, 2

_ABI_VERSION = 2  # must match msd_abi_version() in csrc/host/video_decode.cpp
_vlock = threading.Lock()
_vstate = {"lib": None, "failure": None, "warned": False}


def _bind(lib: ctypes.CDLL) -> None:
    from cvsd_tpu_torch.utils.host_build import BuildError

    lib.msd_abi_version.restype = ctypes.c_int
    abi = int(lib.msd_abi_version())
    if abi != _ABI_VERSION:
        raise BuildError(f"the video decoder's ABI is v{abi}, this binding expects "
                         f"v{_ABI_VERSION}")
    lib.msd_open.restype = ctypes.c_void_p
    lib.msd_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.msd_next.restype = ctypes.c_int
    lib.msd_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.msd_active.restype = ctypes.c_int
    lib.msd_active.argtypes = [ctypes.c_void_p]
    lib.msd_close.argtypes = [ctypes.c_void_p]


def load_video_lib(required: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building at first use) the decoder; None where it cannot be
    built (no opencv4: quietly), or raise naming the cause where
    ``required``."""
    from cvsd_tpu_torch.utils import host_build

    with _vlock:
        return load_library(host_build.build_video, _bind, "the native video decoder",
                            _vstate, required)


def video_available() -> bool:
    return load_video_lib() is not None


def use_native_decode(flag: Optional[bool]) -> bool:
    """``detector.native_decode`` -> whether to decode natively: unset,
    exactly when the decoder builds; ``True`` builds it or raises."""
    from cvsd_tpu_torch.native import resolve

    return resolve(flag, video_available, lambda: load_video_lib(required=True))


class MultiStreamDecoder:
    """Round-robin multiplexed decode over a queue of videos.

    mode: MODE_RAW (source-size RGB), MODE_CONTENT (resize to (nw, nh)),
    MODE_CANVAS (resize + 114-pad to (out, out) at (px, py)): the three
    upload modes of the streaming and preprocess pipelines.
    """

    def __init__(self, paths: Sequence[str], max_streams: int,
                 out_hw: Tuple[int, int], mode: int = MODE_RAW,
                 content_hw: Optional[Tuple[int, int]] = None,
                 pad_xy: Tuple[int, int] = (0, 0), frame_stride: int = 1):
        lib = load_video_lib(required=True)
        self._lib = lib
        self.paths = [str(p) for p in paths]
        self.out_h, self.out_w = int(out_hw[0]), int(out_hw[1])
        nh, nw = content_hw if content_hw is not None else out_hw
        if mode == MODE_CONTENT and (int(nh), int(nw)) != (self.out_h, self.out_w):
            raise ValueError(
                f"CONTENT mode output buffer is (out_h, out_w)=({self.out_h}, "
                f"{self.out_w}); content_hw=({nh}, {nw}) must match it")
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._h = lib.msd_open(arr, len(self.paths), int(max_streams),
                               self.out_w, self.out_h, int(nw), int(nh),
                               int(pad_xy[0]), int(pad_xy[1]), int(mode),
                               int(frame_stride))
        if not self._h:
            raise RuntimeError("msd_open rejected the decoder geometry/stride")

    def _next(self, frames: np.ndarray):
        B = int(frames.shape[0])
        sidx = np.empty(B, np.int32)
        fno = np.zeros(B, np.int32)
        stamp = np.zeros(B, np.float64)
        k = self._lib.msd_next(
            self._h, B,
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            sidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            fno.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            stamp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return sidx, fno, stamp, int(k)

    def next_batch(self, batch_size: int):
        """-> (frames (B, out_h, out_w, 3) uint8 RGB, stream_idx (B,) i32,
        frame_no (B,) i32 1-based, stamp_ms (B,) f64, k filled)."""
        frames = np.empty((int(batch_size), self.out_h, self.out_w, 3), np.uint8)
        sidx, fno, stamp, k = self._next(frames)
        return frames, sidx, fno, stamp, k

    def next_batch_into(self, frames: np.ndarray):
        """Decode straight into a caller's (B, out_h, out_w, 3) uint8 buffer
        (a ring-buffer slot): the zero-copy variant of ``next_batch``.
        Returns (frame_no (B,) i32, stamp_ms (B,) f64, k); entries past k
        are 0."""
        if frames.dtype != np.uint8 or not frames.flags["C_CONTIGUOUS"] \
                or frames.shape[1:] != (self.out_h, self.out_w, 3):
            raise ValueError(f"next_batch_into needs a C-contiguous uint8 (B, {self.out_h}, "
                             f"{self.out_w}, 3) buffer, got {frames.dtype} {frames.shape}")
        _sidx, fno, stamp, k = self._next(frames)
        fno[k:] = 0
        stamp[k:] = 0.0
        return fno, stamp, k

    @property
    def active(self) -> int:
        return int(self._lib.msd_active(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.msd_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
