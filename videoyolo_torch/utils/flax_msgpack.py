"""flax's msgpack checkpoint format, read and written without flax or msgpack.

The JAX package writes its `.params` files with
`flax.serialization.to_bytes` (train/checkpoint.py:32-57): a msgpack map of
nested maps with string keys whose leaves are msgpack extension values:

  ext 1  an ndarray: the msgpack array [shape, dtype name, C-order bytes]
  ext 3  a numpy scalar: the same encoding of a 0-d array

An array above `MAX_CHUNK_SIZE` bytes is written as the map
{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat chunk, ...}}.  `to_bytes` packs as msgpack-python does with
`use_bin_type=True` (the smallest encoding of each int, str, bin, array,
map and ext length; floats as float64), so a tree of numpy arrays gives
the bytes flax gives.  `from_bytes` reads every msgpack type.

Leaves are numpy arrays and scalars, Python scalars, or torch tensors.
numpy has no bfloat16: a bfloat16 leaf is read as a torch.bfloat16
tensor, and a torch.bfloat16 tensor is written under the dtype name
"bfloat16", as jax writes it.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "to_bytes", "from_bytes"]

# flax.serialization.MAX_CHUNK_SIZE: msgpack's limit is 2**31 - 1 bytes a leaf
MAX_CHUNK_SIZE = 2**30
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _array_payload(arr) -> Tuple[Tuple[int, ...], str, bytes]:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            return tuple(arr.shape), "bfloat16", arr.view(torch.int16).numpy().tobytes()
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot serialise an array of dtype {arr.dtype}")
    return tuple(arr.shape), arr.dtype.name, arr.tobytes("C")


def _pack_len(out: bytearray, n: int, fix: Tuple[int, int] | None, codes: Tuple[int, ...]):
    """A length header: the fix form (`fix` = (tag, limit)) below its limit,
    else the 8-, 16- or 32-bit form of `codes` (None where a width has no
    form)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _pack(out: bytearray, obj: Any):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif type(obj) in (bytes, bytearray):
        _pack_len(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out += obj
    elif type(obj) in (list, tuple):
        _pack_len(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def _pack_int(out: bytearray, n: int):
    if 0 <= n < 128 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
        return
    forms = ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64))
    if n < 0:
        forms = ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63))
    for code, fmt, limit in forms:
        if -limit <= n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"msgpack cannot hold the int {n}")


def _pack_ext(out: bytearray, code: int, payload):
    inner = bytearray()
    shape, name, data = payload
    _pack(inner, [list(shape), name, data])
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(inner) in fixext:
        out.append(fixext[len(inner)])
    else:
        _pack_len(out, len(inner), None, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += inner


def _chunk_leaves(tree):
    """The tree with every array leaf above MAX_CHUNK_SIZE bytes in flax's
    chunked form (flax.serialization._chunk)."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        is_tensor = isinstance(tree, torch.Tensor)
        itemsize = tree.element_size() if is_tensor else tree.dtype.itemsize
        if (tree.numel() if is_tensor else tree.size) * itemsize > MAX_CHUNK_SIZE:
            step = max(1, int(MAX_CHUNK_SIZE / itemsize))
            flat = tree.reshape(-1)
            return {
                _CHUNKED: True,
                "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                "chunks": {str(n): flat[i:i + step] for n, i in enumerate(range(0, flat.shape[0], step))},
            }
    return tree


def to_bytes(tree) -> bytes:
    """A nested dict of arrays and scalars -> flax msgpack bytes."""
    out = bytearray()
    _pack(out, _chunk_leaves(tree))
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        tag = self.unpack(">B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.read_map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        widths = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                  0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if tag in widths:
            return self.unpack(widths[tag])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if tag in lens:
            n = self.unpack(lens[tag])
            if tag in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if tag in (0xD9, 0xDA, 0xDB):
                return str(self.take(n), "utf-8")
            if tag in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if tag in (0xDE, 0xDF):
                return self.read_map(n)
            return self.read_ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self.read_ext(fixext[tag])
        raise ValueError(f"unknown msgpack tag 0x{tag:02x}")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        shape, name, data = _Reader(payload).read()
        if name == "bfloat16":
            arr = torch.frombuffer(bytearray(data), dtype=torch.int16).view(torch.bfloat16).reshape(shape)
            return arr.reshape(()) if code == EXT_NPSCALAR else arr
        arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape).copy()
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            cat = torch.cat if isinstance(chunks[0], torch.Tensor) else np.concatenate
            return cat(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def from_bytes(data: bytes):
    """flax msgpack bytes -> the nested dict (chunked arrays joined)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)
