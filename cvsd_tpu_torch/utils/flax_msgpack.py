"""Pure-Python reader and writer of the msgpack subset that
``flax.serialization`` writes (``msgpack_serialize`` / ``msgpack_restore``),
so the port reads and writes the JAX package's checkpoints where neither
``flax`` nor ``msgpack`` is installed.

Handled:
- nil, bool, int (every width), float32/float64, str, bin, array and map in
  their fix/8/16/32 forms, ext in its fixext 1-16 and ext 8/16/32 forms;
- ext 1 (ndarray) and ext 3 (numpy scalar): the payload is itself msgpack
  ``[shape, dtype name, C-order bytes]``. Both decode to numpy arrays (a
  scalar as a 0-d array); ``bfloat16``, which numpy lacks, decodes to a
  torch tensor;
- the chunked-array dict ``{"__msgpack_chunked_array__": True, "shape":
  {...}, "chunks": {...}}`` that flax writes for leaves over
  ``MAX_CHUNK_SIZE`` bytes.

The writer encodes every value in its smallest form, as msgpack-python's
``packb`` does with flax's settings (``use_bin_type``, Python floats as
float64), and writes lists and tuples as ``{"0": ..., "1": ...}`` maps, as
flax's state dicts do, so a tree written here is byte-identical to flax's.
Array payloads are sliced from one ``memoryview`` and copied out whole, never
walked a byte at a time.
"""

from __future__ import annotations

import struct
from typing import Any, List, Mapping, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: leaves over this many bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"

# -- writer -------------------------------------------------------------------


def _header(n: int, fix: int, fix_max: int, codes: Tuple[int, ...], widths: Tuple[str, ...]
            ) -> bytes:
    """A length header: the fix form up to ``fix_max``, else the smallest of
    ``codes`` (8/16/32-bit lengths, or 16/32 for maps and arrays)."""
    if n <= fix_max:
        return bytes([fix | n])
    for code, width in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(width)):
            return struct.pack(">B" + width, code, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 128:
        out.append(bytes([n]))
    elif -32 <= n < 0:
        out.append(struct.pack(">b", n))
    elif n >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if n < lim:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack's 64 bits")
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                               (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if n >= -lim:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _pack_str(s: str, out: List[bytes]) -> None:
    b = s.encode("utf-8")
    out.append(_header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), ("B", "H", "I")))
    out.append(b)


def _pack_bin(b, out: List[bytes]) -> None:
    n = memoryview(b).nbytes
    out.append(_header(n, 0, -1, (0xC4, 0xC5, 0xC6), ("B", "H", "I")))
    out.append(b)


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(bytes([fixext[n], code]))
    else:
        out.append(_header(n, 0, -1, (0xC7, 0xC8, 0xC9), ("B", "H", "I")))
        out.append(bytes([code]))
    out.append(data)


def _array_fields(x: np.ndarray) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array."""
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError(f"cannot serialize an array of dtype {x.dtype}")
    return tuple(int(d) for d in x.shape), x.dtype.name, x.tobytes("C")


def _ndarray_payload(x) -> bytes:
    shape, name, data = _array_fields(x)
    out: List[bytes] = [bytes([0x93]), _header(len(shape), 0x90, 15, (0xDC, 0xDD), ("H", "I"))]
    for d in shape:
        _pack_int(d, out)
    _pack_str(name, out)
    _pack_bin(data, out)
    return b"".join(out)


def _chunked(x: np.ndarray) -> dict:
    """flax's chunked form of an array leaf over MAX_CHUNK_SIZE bytes."""
    step = max(1, int(MAX_CHUNK_SIZE / x.dtype.itemsize))
    flat = x.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + step] for i, j in enumerate(range(0, x.size, step))}}


def _pack(x: Any, out: List[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        if x.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunked(x), out)
        else:
            _pack_ext(EXT_NDARRAY, _ndarray_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x)), out)
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        _pack_str(x, out)
    elif isinstance(x, (bytes, bytearray)):
        _pack_bin(bytes(x), out)
    elif isinstance(x, Mapping):
        out.append(_header(len(x), 0x80, 15, (0xDE, 0xDF), ("H", "I")))
        for k, v in x.items():
            _pack_str(str(k), out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        _pack({str(i): v for i, v in enumerate(x)}, out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts, lists,
    Python scalars, strings and numpy arrays (dict order is kept as given)."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


# -- reader -------------------------------------------------------------------

_FIXED = {  # code -> (struct format of the value, its size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {  # code -> (kind, struct format of the length, its size)
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
    0xC7: ("ext", ">B", 1), 0xC8: ("ext", ">H", 2), 0xC9: ("ext", ">I", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray(payload: memoryview):
    shape, name, data = _Reader(payload).value()
    count = int(np.prod(shape, dtype=np.int64))
    if name == "bfloat16":
        if count == 0:
            return torch.empty(tuple(shape), dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16).reshape(tuple(shape))
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"checkpoint array has dtype {name!r}, which numpy cannot read") from e
    if len(data) != count * dtype.itemsize:
        raise ValueError(f"checkpoint array {name}{tuple(shape)} has {len(data)} bytes")
    return np.frombuffer(data, dtype=dtype).copy().reshape(shape)


def _unchunk(d: dict):
    """The whole leaf of a chunked-array dict (torch chunks are bfloat16)."""
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self._take(size))[0]

    def value(self) -> Any:
        code = self._take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.value() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return str(self._take(code & 0x1F), "utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            return self._unpack(*_FIXED[code])
        if code in _FIXEXT:
            return self._ext(_FIXEXT[code])
        if code not in _LEN:
            raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")
        kind, fmt, size = _LEN[code]
        n = self._unpack(fmt, size)
        if kind == "str":
            return str(self._take(n), "utf-8")
        if kind == "bin":
            return self._take(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self._map(n)
        return self._ext(n)

    def _map(self, n: int):
        d = {}
        for _ in range(n):
            k = self.value()
            d[k] = self.value()
        return _unchunk(d) if _CHUNKED in d else d

    def _ext(self, n: int):
        code = self._unpack(">b", 1)
        data = self._take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            return _ndarray(data)
        raise ValueError(f"unsupported msgpack ext type {code}")


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: bytes -> a tree of dicts and
    numpy arrays (torch tensors for bfloat16), chunked leaves joined."""
    reader = _Reader(memoryview(data))
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return out
