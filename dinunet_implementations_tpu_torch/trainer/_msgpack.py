"""A stdlib MessagePack codec for the trainer's checkpoint files.

It reads and writes what ``flax.serialization`` writes (``msgpack_serialize``
/ ``msgpack_restore``), without flax or msgpack:

- maps, arrays, str, bin, nil, bool, ints and floats (float32 and float64
  read; Python floats written as float64, as msgpack does);
- flax's ext types: code 1 an ndarray, whose payload is the msgpack triple
  ``(shape, dtype name, C-order bytes)``; code 3 a numpy scalar (the same
  payload, 0-d, read back as a scalar); code 2 a native complex, the pair
  ``(real, imag)``;
- flax's chunked form of an array over :data:`MAX_CHUNK_SIZE` bytes, a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat array, ...}}``, as a map's value or the whole tree;
- the dtype name ``bfloat16``, which numpy lacks: read as raw uint16 into a
  ``torch.bfloat16`` tensor, and written from one.

:func:`packb` takes nested dicts (str keys), lists and tuples (packed as
arrays, for payloads only: flax turns tuples into ``{"0": ...}`` maps
before it packs a tree), scalars, numpy arrays and scalars, and torch
tensors. Map keys keep their insertion order.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

#: flax's chunking threshold: arrays of more bytes are split into chunks
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """The bytes are not MessagePack this codec reads."""


# -- encoding -----------------------------------------------------------------


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} does not fit 64 bits")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000), (0xD3, ">q", -2 ** 63)):
            if v >= lo:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} does not fit 64 bits")


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    forms of ``codes`` (None where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} does not fit 32 bits")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _dtype_name_and_bytes(a) -> tuple[tuple, str, bytes]:
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return tuple(a.shape), "bfloat16", a.contiguous().view(torch.int16).numpy().tobytes()
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes are not supported")
    return a.shape, a.dtype.name, a.tobytes("C")


def _ndarray_bytes(a) -> bytes:
    shape, name, raw = _dtype_name_and_bytes(a)
    return packb((tuple(int(d) for d in shape), name, raw))


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if torch.is_tensor(a) else a.nbytes


def _chunk(a) -> dict:
    """flax's ``_chunk``: the flat array in chunks of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    item = a.element_size() if torch.is_tensor(a) else a.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = a.reshape(-1)
    n = flat.numel() if torch.is_tensor(a) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[lo:lo + size] for i, lo in enumerate(range(0, n, size))}}


def _is_array(v) -> bool:
    return isinstance(v, np.ndarray) or torch.is_tensor(v)


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif isinstance(v, int) and not isinstance(v, np.generic):
        _pack_int(out, v)
    elif isinstance(v, float) and not isinstance(v, np.generic):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, _chunk(x) if _is_array(x) and _nbytes(x) > MAX_CHUNK_SIZE else x)
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif _is_array(v):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    elif isinstance(v, complex):
        _pack_ext(out, EXT_COMPLEX, packb((v.real, v.imag)))
    else:
        raise MsgpackError(f"cannot pack {type(v).__name__}")


def packb(tree) -> bytes:
    """``tree`` as MessagePack bytes, in flax's encoding (module
    docstring); an array over :data:`MAX_CHUNK_SIZE` bytes, as a map's
    value or the whole tree, is written in chunks."""
    out = bytearray()
    _pack(out, _chunk(tree) if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE else tree)
    return bytes(out)


# -- decoding -----------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"), 0xDF: (">I", "map")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read(r: _Reader, raw_str: bool):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw_str)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw_str) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        s = bytes(r.take(b & 0x1F))
        return s if raw_str else s.decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXEXT[b])))
    if b in _LEN:
        fmt, kind = _LEN[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            s = bytes(r.take(n))
            return s if raw_str else s.decode("utf-8")
        if kind == "ext":
            code = r.unpack(">b")
            return _ext(code, bytes(r.take(n)))
        if kind == "array":
            return [_read(r, raw_str) for _ in range(n)]
        return _read_map(r, n, raw_str)
    raise MsgpackError(f"unknown MessagePack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int, raw_str: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r, raw_str)
        out[k] = _read(r, raw_str)
    return out


def _ndarray_from_bytes(data: bytes):
    shape, name, raw = unpackb(data, raw_str=True)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        u = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(u.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        a = _ndarray_from_bytes(data)
        return a if torch.is_tensor(a) else a[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise MsgpackError(f"unknown ext type {code}")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if torch.is_tensor(chunks[0]):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(t):
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps back into
    arrays, through nested maps."""
    if isinstance(t, dict):
        if _CHUNKED in t:
            return _unchunk(t)
        for k, v in t.items():
            if isinstance(v, dict):
                t[k] = _unchunk_tree(v)
    return t


def unpackb(data: bytes, raw_str: bool = False):
    """Decode one MessagePack object (module docstring); chunked arrays are
    joined. ``raw_str`` returns strings as bytes."""
    r = _Reader(data)
    out = _read(r, raw_str)
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes")
    return _unchunk_tree(out)
