"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``cvsd_tpu_torch/csrc/`` has a plain C interface and is
compiled on first use into a shared library under ``csrc/build/`` (listed in
``.gitignore``), or under ``$CVSD_COMPILE_CACHE_DIR``
(``utils/compile_cache.py`` moves ``BUILD_DIR``). The sources share the headers beside them (``*.cuh``). The
library's name carries a hash of the source, every header and the flags, so
an edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU-only test host has no ``nvcc``.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xptxas -v -shared -Xcompiler -fPIC -o build/<name>-<hash>.so <name>.cu

``-fmad=false`` keeps every ``a*b+c`` as a separate rounded multiply and add,
so float results round where the plain PyTorch versions round. Never
``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) for the current build of ``name``, or '' before it is built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` process per source, all started together. Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
            lib.cvsd_cuda_error_string.argtypes = [ctypes.c_int]
            lib.cvsd_cuda_error_string.restype = ctypes.c_char_p
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if code:
        msg = lib.cvsd_cuda_error_string(int(code)).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
