"""flax's msgpack checkpoint format, read and written without the ``msgpack``
or ``flax`` packages.

The JAX package writes its checkpoints with
``flax.serialization.msgpack_serialize`` (``state.msgpack``). This module
carries its own decoder of the subset that function emits: maps, arrays,
str, bin, int, float, bool and nil, and three extension types:

  1  ndarray         the msgpack triple (shape, dtype name, C-order bytes)
  2  native complex  the msgpack pair (real, imag)
  3  numpy scalar    an ndarray of shape ()

``restore(data)`` returns the tree: dicts (str keys), lists, Python
scalars, read-only numpy arrays, and torch tensors for ``bfloat16`` arrays
(numpy has no bfloat16; they decode through ``torch.frombuffer``). Arrays
that flax split into chunks (``{'__msgpack_chunked_array__': True, 'shape':
..., 'chunks': ...}``, arrays over ``MAX_CHUNK_SIZE`` bytes) are joined
again. An unknown extension type, a truncated buffer, trailing bytes or an
unknown type byte raise ``ValueError`` naming the offset.

``pack(tree)`` writes the same bytes as ``msgpack_serialize`` (the same
chunking, the same encodings), from numpy arrays, numpy scalars, torch
tensors and Python values. It makes JAX-format checkpoints where JAX is
not installed; the port's own checkpoints stay ``state.pt``.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_SCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: arrays of more bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30

_TORCH_DTYPES = {
    torch.float16: "float16", torch.bfloat16: "bfloat16", torch.float32: "float32",
    torch.float64: "float64", torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}

# fixed-size headers: type byte -> (struct format, kind)
_FIXED = {
    0xcc: (">B", "int"), 0xcd: (">H", "int"), 0xce: (">I", "int"), 0xcf: (">Q", "int"),
    0xd0: (">b", "int"), 0xd1: (">h", "int"), 0xd2: (">i", "int"), 0xd3: (">q", "int"),
    0xca: (">f", "float"), 0xcb: (">d", "float"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
    0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Decoder:
    def __init__(self, data: bytes, what: str):
        self.data, self.what = memoryview(data), what

    def fail(self, pos: int, message: str):
        raise ValueError(f"{self.what}: {message} at offset {pos}")

    def take(self, pos: int, n: int) -> tuple[memoryview, int]:
        if pos + n > len(self.data):
            self.fail(pos, f"truncated: {n} bytes needed, {len(self.data) - pos} left")
        return self.data[pos:pos + n], pos + n

    def unpack(self, fmt: str, pos: int) -> tuple[Any, int]:
        raw, end = self.take(pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], end

    def decode(self, pos: int = 0) -> tuple[Any, int]:
        start = pos
        head, pos = self.unpack(">B", pos)
        if head <= 0x7f:
            return head, pos
        if head >= 0xe0:
            return head - 0x100, pos
        if 0x80 <= head <= 0x8f:
            return self.map(head & 0x0f, pos)
        if 0x90 <= head <= 0x9f:
            return self.array(head & 0x0f, pos)
        if 0xa0 <= head <= 0xbf:
            return self.str(head & 0x1f, pos)
        if head == 0xc0:
            return None, pos
        if head in (0xc2, 0xc3):
            return head == 0xc3, pos
        if head in _FIXEXT:
            return self.ext(_FIXEXT[head], pos, start)
        if head not in _FIXED:
            self.fail(start, f"unknown msgpack type byte 0x{head:02x}")
        fmt, kind = _FIXED[head]
        value, pos = self.unpack(fmt, pos)
        if kind in ("int", "float"):
            return value, pos
        if kind == "str":
            return self.str(value, pos)
        if kind == "bin":
            raw, pos = self.take(pos, value)
            return bytes(raw), pos
        if kind == "array":
            return self.array(value, pos)
        if kind == "map":
            return self.map(value, pos)
        return self.ext(value, pos, start)

    def str(self, n: int, pos: int) -> tuple[str, int]:
        raw, pos = self.take(pos, n)
        return bytes(raw).decode("utf-8"), pos

    def array(self, n: int, pos: int) -> tuple[list, int]:
        out = []
        for _ in range(n):
            item, pos = self.decode(pos)
            out.append(item)
        return out, pos

    def map(self, n: int, pos: int) -> tuple[dict, int]:
        out = {}
        for _ in range(n):
            key, pos = self.decode(pos)
            out[key], pos = self.decode(pos)
        return out, pos

    def ext(self, n: int, pos: int, start: int) -> tuple[Any, int]:
        code, pos = self.unpack(">b", pos)
        body, end = self.take(pos, n)
        if code == EXT_NDARRAY:
            return _ndarray(bytes(body), f"{self.what} (ndarray at offset {start})"), end
        if code == EXT_SCALAR:
            arr = _ndarray(bytes(body), f"{self.what} (scalar at offset {start})")
            return (arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]), end
        if code == EXT_COMPLEX:
            pair = _decode_all(bytes(body), f"{self.what} (complex at offset {start})")
            return complex(pair[0], pair[1]), end
        self.fail(start, f"unknown msgpack extension type {code}")


def _decode_all(data: bytes, what: str) -> Any:
    decoder = _Decoder(data, what)
    value, end = decoder.decode(0)
    if end != len(data):
        decoder.fail(end, f"{len(data) - end} trailing bytes")
    return value


def _ndarray(body: bytes, what: str):
    shape, dtype, buf = _decode_all(body, what)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    shape = tuple(int(s) for s in shape)
    if dtype == "bfloat16":
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _unchunk(tree):
    """Join flax's chunked arrays back into arrays, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes, what: str = "msgpack data"):
    """The tree ``flax.serialization.msgpack_restore`` returns for ``data``
    (bfloat16 arrays as torch tensors); ``what`` names the data in errors."""
    return _unchunk(_decode_all(data, what))


# ----------------------------------------------------------------- writing

def _int(x: int) -> bytes:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    for lo, hi, head, fmt in ((0, 0xff, 0xcc, ">B"), (-0x80, -1, 0xd0, ">b"),
                              (0, 0xffff, 0xcd, ">H"), (-0x8000, -1, 0xd1, ">h"),
                              (0, 0xffffffff, 0xce, ">I"), (-0x80000000, -1, 0xd2, ">i"),
                              (0, 0xffffffffffffffff, 0xcf, ">Q"),
                              (-0x8000000000000000, -1, 0xd3, ">q")):
        if lo <= x <= hi:
            return bytes([head]) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, heads: tuple[int, int, int]) -> bytes:
    """The header of a str / bin / array / map of ``n`` items or bytes."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for head, fmt, top in zip(heads, (">B", ">H", ">I"), (0xff, 0xffff, 0xffffffff)):
        if head is not None and n <= top:
            return bytes([head]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items do not fit one msgpack object")


def _ext(code: int, body: bytes) -> bytes:
    n = len(body)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    head = bytes([fix]) if fix else _sized(n, None, 0, (0xc7, 0xc8, 0xc9))
    return head + struct.pack(">b", code) + body


def _array_bytes(x) -> tuple[tuple, str, bytes]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype not in _TORCH_DTYPES:
            raise TypeError(f"cannot pack a torch tensor of dtype {x.dtype}")
        raw = x.reshape(-1).view(torch.uint8).numpy().tobytes() if x.numel() else b""
        return tuple(x.shape), _TORCH_DTYPES[x.dtype], raw
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be packed")
    return x.shape, x.dtype.name, x.tobytes("C")


def _ndarray_body(x) -> bytes:
    shape, dtype, raw = _array_bytes(x)
    return (_sized(3, 0x90, 0x0f, (None, 0xdc, 0xdd))
            + _sized(len(shape), 0x90, 0x0f, (None, 0xdc, 0xdd)) + b"".join(_int(int(s)) for s in shape)
            + _str(dtype) + _sized(len(raw), None, 0, (0xc4, 0xc5, 0xc6)) + raw)


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xa0, 0x1f, (0xd9, 0xda, 0xdb)) + raw


def _encode(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        out.append(_ext(EXT_NDARRAY, _ndarray_body(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_SCALAR, _ndarray_body(np.asarray(x))))
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is complex:
        out.append(_ext(EXT_COMPLEX, b"\x92" + b"".join(
            b"\xcb" + struct.pack(">d", v) for v in (x.real, x.imag))))
    elif type(x) is str:
        out.append(_str(x))
    elif type(x) is bytes:
        out.append(_sized(len(x), None, 0, (0xc4, 0xc5, 0xc6)) + x)
    elif type(x) is list:
        out.append(_sized(len(x), 0x90, 0x0f, (None, 0xdc, 0xdd)))
        for item in x:
            _encode(item, out)
    elif type(x) is dict:
        out.append(_sized(len(x), 0x80, 0x0f, (None, 0xde, 0xdf)))
        for key, value in x.items():
            _encode(key, out)
            _encode(value, out)
    else:
        raise TypeError(f"cannot pack {type(x).__name__!r} (flax's msgpack subset)")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's chunked form of an array over MAX_CHUNK_SIZE bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in enumerate(range(0, n, size))}}


def _chunked(tree):
    """The tree as msgpack_serialize packs it: every dict in sorted key order
    (its copy of the tree through jax.tree_util sorts them), big arrays
    chunked."""
    if isinstance(tree, dict):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def pack(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte: dicts
    (their keys sorted, as flax's copy of the tree sorts them), lists, None, bool, int, float, complex, str, bytes,
    numpy arrays and scalars, and torch tensors (as the ndarray of their
    dtype; bfloat16 too)."""
    out: list[bytes] = []
    _encode(_chunked(tree), out)
    return b"".join(out)
