"""Binary PLY reader/writer built on numpy structured arrays.

Capability parity with the reference's generic PLY layer (ref: src/ply.cpp:72-281,
src/core/binaryattribute.h:12-111): header parsing into a property map, one bulk
read of the vertex blob, strided per-property access, and byte-exact round-trip
writing. Instead of a hand-rolled {type,size,offset} accessor we map the header
straight onto a numpy structured dtype, so property access is a zero-copy view
and the whole file loads with a single ``np.frombuffer``.

Only ``format binary_little_endian 1.0`` with a single ``vertex`` element is
required by splat files; ASCII and big-endian are supported for robustness.
"""

from __future__ import annotations

import dataclasses
from typing import IO, Union

import numpy as np

# PLY scalar type names -> numpy dtype (little-endian applied at read time).
# Mirrors the type table in the reference parser (ref: src/ply.cpp:16-36).
_PLY_TO_NUMPY = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}
_NUMPY_TO_PLY = {
    np.dtype(np.int8): "char",
    np.dtype(np.uint8): "uchar",
    np.dtype(np.int16): "short",
    np.dtype(np.uint16): "ushort",
    np.dtype(np.int32): "int",
    np.dtype(np.uint32): "uint",
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
}


@dataclasses.dataclass
class PlyData:
    """A single-element PLY file: named vertex properties as a structured array."""

    vertices: np.ndarray  # structured array, shape [N]

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def property_names(self) -> tuple:
        return tuple(self.vertices.dtype.names or ())

    def has(self, *names: str) -> bool:
        have = set(self.property_names)
        return all(n in have for n in names)

    def column(self, name: str) -> np.ndarray:
        """A property as a contiguous float-preserving 1-D array (copies)."""
        return np.ascontiguousarray(self.vertices[name])

    def columns(self, names, dtype=np.float32) -> np.ndarray:
        """Stack several properties into an [N, len(names)] array."""
        return np.stack([self.vertices[n].astype(dtype) for n in names], axis=-1)


def _parse_header(f: IO[bytes]):
    """Parse the header up to and including end_header.

    Returns (num_vertices, [(name, dtype_str)], fmt) where fmt is one of
    'binary_little_endian', 'binary_big_endian', 'ascii'.
    Mirrors the reference header walk (ref: src/ply.cpp:140-254) but keyed on a
    numpy dtype instead of a BinaryAttribute map.
    """
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError(f"not a PLY file (magic={magic!r})")
    fmt = None
    num_vertices = None
    props = []
    in_vertex_element = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == "comment":
            continue
        if key == "format":
            fmt = tokens[1]
            if fmt not in ("binary_little_endian", "binary_big_endian", "ascii"):
                raise ValueError(f"unsupported PLY format {fmt}")
        elif key == "element":
            in_vertex_element = tokens[1] == "vertex"
            if in_vertex_element:
                num_vertices = int(tokens[2])
            elif int(tokens[2]) != 0:
                raise ValueError(f"unsupported PLY element {tokens[1]}")
        elif key == "property":
            if not in_vertex_element:
                continue
            if tokens[1] == "list":
                raise ValueError("list properties are not supported")
            type_name, prop_name = tokens[1], tokens[2]
            if type_name not in _PLY_TO_NUMPY:
                raise ValueError(f"unknown PLY type {type_name}")
            props.append((prop_name, _PLY_TO_NUMPY[type_name]))
        elif key == "end_header":
            break
    if fmt is None or num_vertices is None:
        raise ValueError("malformed PLY header")
    return num_vertices, props, fmt


def read_ply(path_or_file: Union[str, IO[bytes]]) -> PlyData:
    """Read a PLY file (one bulk read of the vertex blob, ref: src/ply.cpp:79-84)."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "rb") as f:
            return read_ply(f)
    f = path_or_file
    num_vertices, props, fmt = _parse_header(f)
    endian = ">" if fmt == "binary_big_endian" else "<"
    dtype = np.dtype([(name, endian + dt) for name, dt in props])
    if fmt == "ascii":
        rows = []
        for _ in range(num_vertices):
            rows.append(tuple(float(x) for x in f.readline().split()))
        vertices = np.array(rows, dtype=dtype)
    else:
        blob = f.read(num_vertices * dtype.itemsize)
        if len(blob) < num_vertices * dtype.itemsize:
            raise ValueError("PLY vertex data truncated")
        vertices = np.frombuffer(blob, dtype=dtype, count=num_vertices).copy()
        if endian == ">":
            vertices = vertices.astype(dtype.newbyteorder("<"))
    return PlyData(vertices=vertices)


def write_ply(path_or_file: Union[str, IO[bytes]], data: PlyData) -> None:
    """Write binary_little_endian PLY (header + one blob, ref: src/ply.cpp:256-281)."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "wb") as f:
            write_ply(f, data)
        return
    f = path_or_file
    vertices = data.vertices
    if vertices.dtype.names is None:
        raise ValueError("vertices must be a structured array")
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {len(vertices)}"]
    out_fields = []
    for name in vertices.dtype.names:
        base = vertices.dtype.fields[name][0].newbyteorder("=")
        if base not in _NUMPY_TO_PLY:
            raise ValueError(f"cannot write dtype {base} for property {name}")
        lines.append(f"property {_NUMPY_TO_PLY[base]} {name}")
        out_fields.append((name, "<" + base.str[1:]))
    lines.append("end_header")
    f.write(("\n".join(lines) + "\n").encode("ascii"))
    out = vertices.astype(np.dtype(out_fields), copy=False)
    f.write(np.ascontiguousarray(out).tobytes())


def make_ply(columns: dict) -> PlyData:
    """Build PlyData from {name: 1-D array}; order of dict keys is property order."""
    n = None
    fields = []
    for name, arr in columns.items():
        arr = np.asarray(arr)
        if n is None:
            n = arr.shape[0]
        elif arr.shape[0] != n:
            raise ValueError("all columns must share the leading dimension")
        fields.append((name, arr.dtype.str))
    vertices = np.empty(n, dtype=np.dtype(fields))
    for name, arr in columns.items():
        vertices[name] = np.asarray(arr)
    return PlyData(vertices=vertices)
