"""Minimal PLY reader (ascii and binary_little_endian), NumPy only: the
port's copy of ``gspn_tpu/data/ply.py``.

ScanNet's ``_vh_clean_2.ply`` meshes are binary little-endian with float
vertex properties and uchar colours, which this covers. Only the
``vertex`` element is read (faces are skipped).
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1",
    "uchar": "u1",
    "int8": "i1",
    "uint8": "u1",
    "short": "i2",
    "ushort": "u2",
    "int16": "i2",
    "uint16": "u2",
    "int": "i4",
    "uint": "u4",
    "int32": "i4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def read_ply_vertices(path: str) -> dict[str, np.ndarray]:
    """Returns {property_name: (N,) array} for the vertex element."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop, dtype)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tokens = line.strip().split()
            if not tokens:
                continue
            key = tokens[0]
            if key == b"format":
                fmt = tokens[1].decode()
            elif key == b"element":
                elements.append([tokens[1].decode(), int(tokens[2]), []])
            elif key == b"property":
                if tokens[1] == b"list":
                    elements[-1][2].append(
                        (tokens[4].decode(), "LIST", tokens[2].decode(), tokens[3].decode())
                    )
                else:
                    elements[-1][2].append(
                        (tokens[2].decode(), _PLY_DTYPES[tokens[1].decode()])
                    )
            elif key == b"end_header":
                break

        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"unsupported PLY format {fmt}")

        out = {}
        for name, count, props in elements:
            if name == "vertex":
                if any(p[1] == "LIST" for p in props):
                    raise ValueError("list property in vertex element")
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                if fmt == "ascii":
                    rows = [tuple(f.readline().split()) for _ in range(count)]
                    arr = np.array(rows, dtype=dt)
                else:
                    arr = np.frombuffer(f.read(count * dt.itemsize), dtype=dt)
                for p in props:
                    out[p[0]] = np.ascontiguousarray(arr[p[0]])
            else:
                # skip non-vertex elements (only valid if they come after
                # vertex, which holds for ScanNet meshes)
                break
        return out
