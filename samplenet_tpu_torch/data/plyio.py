"""Minimal PLY point-cloud IO, numpy only.

A copy of samplenet_tpu/data/plyio.py (the port cannot import the JAX
package): vertex clouds with float properties, ascii or
binary_little_endian, the subset the reconstruction pipeline reads.
"""

from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
}


def load_ply(path: str) -> np.ndarray:
    """The vertex element of a PLY file as [N, num_props] float32 (x, y, z
    first for every file the pipelines read)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str]]]] = []
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[-1],
                                   "list:" + tokens[2] + ":" + tokens[3]))
                else:
                    cur[2].append((tokens[-1], tokens[1]))
            elif tokens[0] == "end_header":
                break
        if not elements or elements[0][0] != "vertex":
            raise ValueError(f"{path}: the vertex element must come first")
        _, count, props = elements[0]
        if any(t.startswith("list:") for _, t in props):
            raise ValueError(f"{path}: list properties on vertex unsupported")
        if fmt == "ascii":
            data = np.asarray([[float(v) for v in f.readline().split()]
                               for _ in range(count)], np.float32)
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(n, _PLY_TO_NP[t]) for n, t in props])
            raw = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
            data = np.stack([raw[n].astype(np.float32) for n, _ in props],
                            axis=1)
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")
    return data


def save_ply(path: str, points: np.ndarray, *, binary: bool = True) -> None:
    """Writes [N, 3] xyz points."""
    points = np.asarray(points, np.float32)
    header = [
        "ply",
        "format binary_little_endian 1.0" if binary else "format ascii 1.0",
        f"element vertex {len(points)}",
        "property float x",
        "property float y",
        "property float z",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(points.astype("<f4").tobytes())
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n".encode("ascii"))
