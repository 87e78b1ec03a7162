"""Build the port's host C++ (``csrc/host/``) with the host compiler and load
it with ``ctypes``: the host-compiler sibling of ``utils/cuda_build.py``.

The native host runtime (``cvsd_tpu_torch/native/``) sits over three
sources with a plain C interface: ``csv_writer.cpp`` and ``ring_buffer.cpp``
(one library, ``cvsd_native``) and ``video_decode.cpp`` (``cvsd_video``,
which needs OpenCV's C++ development files, found through ``pkg-config
opencv4``). Each library is compiled on first use with ``$CXX`` (default
``g++``) and the reference Makefile's flags

    $CXX -O3 -std=c++17 -fPIC -Wall -Wextra -shared -pthread -o <lib> <srcs>

into the kernels' build directory (``cuda_build.BUILD_DIR``, listed in
``.gitignore``; ``CVSD_COMPILE_CACHE_DIR`` moves it). The file name carries
a hash of the sources, the flags, the compiler and the OpenCV flags, so an
edited source is rebuilt and a stale library is never loaded. Several
processes may build at once (test workers): each compiles into its own
temporary file and renames it into place. Nothing runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Sequence, Tuple

from cvsd_tpu_torch.utils import cuda_build

HOST_DIR = cuda_build.CSRC_DIR / "host"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-pthread")
TSAN_FLAGS = ("-O1", "-g", "-std=c++17", "-fsanitize=thread", "-pthread")


class BuildError(RuntimeError):
    """A host library could not be built; the message names the missing
    tool (the compiler, ``opencv4``) or carries the compiler's log."""

    quiet = False  # True: an optional dependency is absent, not a failed build


class MissingOpenCV(BuildError):
    """OpenCV's C++ development files are absent: the decoder is not built
    (as the reference Makefile skips it), which is no failure to warn of."""

    quiet = True


def compiler() -> str:
    """The host C++ compiler's path: ``$CXX``, default ``g++``."""
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if not found:
        raise BuildError(f"the host C++ compiler {name!r} ($CXX, default g++) was not found")
    return found


def opencv_flags() -> Tuple[List[str], List[str]]:
    """(cflags, libs) of ``pkg-config opencv4``; raises naming opencv4 where
    OpenCV's C++ development files are missing (the Makefile's rule)."""
    pc = shutil.which("pkg-config")
    if not pc:
        raise MissingOpenCV("the native video decoder needs OpenCV's C++ development files "
                            "(pkg-config opencv4), and pkg-config was not found")
    out = []
    for what in ("--cflags", "--libs"):
        r = subprocess.run([pc, what, "opencv4"], capture_output=True, text=True)
        if r.returncode != 0:
            raise MissingOpenCV("the native video decoder needs OpenCV's C++ development "
                                f"files: pkg-config opencv4 failed: {r.stderr.strip()}")
        out.append(r.stdout.split())
    return out[0], out[1]


def _output_path(name: str, sources: Sequence[str], cmd_flags: Sequence[str],
                 suffix: str) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.encode() + b"\0" + (HOST_DIR / src).read_bytes())
    h.update(" ".join(cmd_flags).encode())
    return Path(cuda_build.BUILD_DIR) / f"{name}-{h.hexdigest()[:16]}{suffix}"


def _compile(name: str, sources: Sequence[str], flags: Sequence[str],
             libs: Sequence[str] = (), suffix: str = ".so") -> Path:
    cxx = compiler()
    out = _output_path(name, sources, [cxx, *flags, *libs], suffix)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=out.parent)
    os.close(fd)
    cmd = [cxx, *flags, "-o", tmp, *[str(HOST_DIR / s) for s in sources], *libs]
    r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise BuildError(f"building {name} failed ({os.path.basename(cxx)} exit "
                         f"{r.returncode}):\n{' '.join(cmd)}\n{r.stdout}")
    os.chmod(tmp, 0o755)
    os.replace(tmp, out)
    return out


def build_native() -> Path:
    """The CSV writer and the ring buffer (``libcvsd_native`` of the
    reference Makefile)."""
    return _compile("cvsd_native", ("csv_writer.cpp", "ring_buffer.cpp"),
                    CXXFLAGS + LDFLAGS)


def build_video() -> Path:
    """The multi-stream video decoder (``libcvsd_video``); needs opencv4."""
    cflags, libs = opencv_flags()
    return _compile("cvsd_video", ("video_decode.cpp",), [*CXXFLAGS, *cflags, *LDFLAGS], libs)


def build_ring_stress_tsan() -> Path:
    """The ring buffer's race harness, built with ThreadSanitizer (the
    Makefile's ``ring_stress_tsan``): an executable that exits 0 on a clean
    run and non-zero on a detected race or a lost item."""
    return _compile("ring_stress_tsan", ("ring_stress.cpp", "ring_buffer.cpp"), TSAN_FLAGS,
                    suffix="")
