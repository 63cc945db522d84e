"""Minimal PLY reader/writer: binary little-endian write, binary and ascii
read (counterpart of reduced_3dgs_tpu/models/ply.py, numpy only).

One structured array per element, in the byte layout `plyfile` writes, so
files are interchangeable with the JAX package and the 3DGS ecosystem.
``write_ply`` and ``read_ply`` go through the native library
(``native_io``) where it is built and takes the file, else through the
numpy code here, which defines the behaviour; ``native_io.last_path`` says
which ran.
"""
from __future__ import annotations

import io
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from . import native_io

_DTYPE_TO_PLY = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}
_PLY_TO_DTYPE = {v: k for k, v in _DTYPE_TO_PLY.items()}
_PLY_TO_DTYPE.update({
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
})


def encode_ply(elements: "OrderedDict[str, np.ndarray]") -> Tuple[bytes, List[bytes]]:
    """The binary_little_endian header and each element's record bytes."""
    header = ["ply", "format binary_little_endian 1.0"]
    for name, arr in elements.items():
        if arr.dtype.names is None:
            raise ValueError(f"element {name!r} must be a structured array")
        header.append(f"element {name} {len(arr)}")
        for field in arr.dtype.names:
            base = arr.dtype.fields[field][0]
            code = base.str.lstrip("<>|=")
            header.append(f"property {_DTYPE_TO_PLY[code]} {field}")
    header.append("end_header\n")
    return ("\n".join(header).encode("ascii"),
            [np.ascontiguousarray(arr).tobytes() for arr in elements.values()])


def write_ply(path: str, elements: "OrderedDict[str, np.ndarray]") -> None:
    """Write a binary_little_endian PLY with one record-array per element.

    Args:
      path: output file path.
      elements: ordered mapping element-name -> numpy structured array.
    """
    header, blobs = encode_ply(elements)
    if native_io.write_ply_native(path, header, blobs):
        return
    with open(path, "wb") as f:
        f.write(header)
        for blob in blobs:
            f.write(blob)


def read_ply(path: str) -> "OrderedDict[str, np.ndarray]":
    """Read a PLY file; returns ordered mapping element-name -> record array."""
    out = native_io.read_ply_native(path)
    if out is not None:
        return out
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_txt = data[:end].decode("ascii", errors="replace")
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = None
    elems: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    for line in header_txt.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elems.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise NotImplementedError("list properties not supported")
            elems[-1][2].append((parts[-1], _PLY_TO_DTYPE[parts[1]]))

    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    if fmt == "binary_little_endian":
        offset = 0
        for name, count, props in elems:
            dtype = np.dtype([(p, "<" + t) for p, t in props])
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
            out[name] = arr
            offset += dtype.itemsize * count
    elif fmt == "ascii":
        text = io.StringIO(body.decode("ascii"))
        for name, count, props in elems:
            dtype = np.dtype([(p, t) for p, t in props])
            rows = [tuple(text.readline().split()) for _ in range(count)]
            out[name] = np.array([tuple(np.array(r, dtype=np.float64)) for r in rows],
                                 dtype=dtype)
    else:
        raise NotImplementedError(f"PLY format {fmt!r} not supported")
    return out


def fields_to_struct(arrays: Dict[str, np.ndarray], order: List[str]) -> np.ndarray:
    """Pack named 1-D arrays into a structured array with the given field order."""
    dtype = np.dtype([(k, arrays[k].dtype.str.lstrip("<>|=")) for k in order])
    out = np.empty(len(next(iter(arrays.values()))), dtype=dtype)
    for k in order:
        out[k] = arrays[k]
    return out
