"""Self-contained PLY reader/writer (no plyfile/open3d dependency).

Supports ascii and binary_little_endian PLY with arbitrary vertex properties
plus triangle face lists — enough for:
  * Gaussian-Splatting checkpoint PLYs (the f_dc_*/f_rest_*/opacity/scale_*/
    rot_* layout of the reference's GaussianModel.save_ply,
    third_party/gaussian-splatting/scene/gaussian_model.py:191-256),
  * colored point clouds from SfM,
  * triangle meshes produced by TSDF fusion.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
               "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


@dataclass
class PlyData:
    """Parsed PLY: per-element dict of property-name -> numpy array, plus an
    optional (F, 3) int faces array."""

    vertex: Dict[str, np.ndarray] = field(default_factory=dict)
    faces: Optional[np.ndarray] = None

    @property
    def positions(self) -> np.ndarray:
        return np.stack([self.vertex["x"], self.vertex["y"], self.vertex["z"]], axis=1)

    @property
    def colors(self) -> Optional[np.ndarray]:
        if "red" in self.vertex:
            c = np.stack([self.vertex["red"], self.vertex["green"], self.vertex["blue"]], axis=1)
            if c.dtype == np.uint8:
                return c.astype(np.float64) / 255.0
            return c
        return None


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = data.find(b"\n", header_end)
    header = data[:nl].decode("ascii", errors="replace")
    body = data[nl + 1:]

    fmt = None
    elements: List[Tuple[str, int, list]] = []  # (name, count, [(prop, dtype) or ('__list__', name, idx_dt, val_dt)])
    cur = None
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append(("__list__", parts[4], _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]]))
            else:
                cur[2].append((parts[2], _PLY_DTYPES[parts[1]]))

    out = PlyData()
    if fmt == "ascii":
        text_rows = body.decode("ascii").split("\n")
        row_i = 0
        for name, count, props in elements:
            if any(p[0] == "__list__" for p in props):
                faces = []
                for _ in range(count):
                    vals = text_rows[row_i].split(); row_i += 1
                    n = int(vals[0])
                    faces.append([int(v) for v in vals[1:1 + n]])
                if name == "face":
                    out.faces = np.asarray(faces, dtype=np.int64)
            else:
                cols = {p[0]: [] for p in props}
                for _ in range(count):
                    vals = text_rows[row_i].split(); row_i += 1
                    for (pname, pdt), v in zip(props, vals):
                        cols[pname].append(v)
                if name == "vertex":
                    for (pname, pdt) in props:
                        out.vertex[pname] = np.asarray(cols[pname], dtype=np.dtype(pdt))
    elif fmt == "binary_little_endian":
        offset = 0
        for name, count, props in elements:
            if any(p[0] == "__list__" for p in props):
                # Fast path: assume constant list length (triangles).
                _, _, idx_dt, val_dt = props[0]
                idx_size = np.dtype(idx_dt).itemsize
                if count == 0:
                    if name == "face":
                        out.faces = np.zeros((0, 3), dtype=np.int64)
                    continue
                n = int(np.frombuffer(body, dtype="<" + idx_dt, count=1, offset=offset)[0])
                rec = np.dtype([("n", "<" + idx_dt), ("v", "<" + val_dt, (n,))])
                arr = np.frombuffer(body, dtype=rec, count=count, offset=offset)
                if not np.all(arr["n"] == n):
                    raise ValueError("variable-length PLY face lists unsupported")
                offset += rec.itemsize * count
                if name == "face":
                    out.faces = arr["v"].astype(np.int64)
            else:
                rec = np.dtype([(pname, "<" + pdt) for pname, pdt in props])
                arr = np.frombuffer(body, dtype=rec, count=count, offset=offset)
                offset += rec.itemsize * count
                if name == "vertex":
                    for pname, _ in props:
                        out.vertex[pname] = np.ascontiguousarray(arr[pname])
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return out


def write_ply(path: str, vertex: Dict[str, np.ndarray],
              faces: Optional[np.ndarray] = None, *, ascii_fmt: bool = False) -> None:
    """Write a PLY. ``vertex`` is an ordered dict of equal-length 1-D arrays."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    names = list(vertex.keys())
    n = len(vertex[names[0]]) if names else 0
    cols = {k: np.asarray(v).reshape(n) for k, v in vertex.items()}

    hdr = io.StringIO()
    hdr.write("ply\n")
    hdr.write("format {} 1.0\n".format("ascii" if ascii_fmt else "binary_little_endian"))
    hdr.write(f"element vertex {n}\n")
    for k in names:
        hdr.write(f"property {_INV_DTYPES[cols[k].dtype.str[1:]]} {k}\n")
    if faces is not None:
        hdr.write(f"element face {len(faces)}\n")
        hdr.write("property list uchar int vertex_indices\n")
    hdr.write("end_header\n")

    with open(path, "wb") as f:
        f.write(hdr.getvalue().encode("ascii"))
        if ascii_fmt:
            for i in range(n):
                f.write((" ".join(repr(float(cols[k][i])) if cols[k].dtype.kind == "f"
                                  else str(int(cols[k][i])) for k in names) + "\n").encode())
            if faces is not None:
                for face in np.asarray(faces):
                    f.write((f"{len(face)} " + " ".join(str(int(v)) for v in face) + "\n").encode())
        else:
            rec = np.dtype([(k, "<" + cols[k].dtype.str[1:]) for k in names])
            arr = np.empty(n, dtype=rec)
            for k in names:
                arr[k] = cols[k]
            f.write(arr.tobytes())
            if faces is not None:
                faces = np.asarray(faces, dtype=np.int32)
                frec = np.dtype([("n", "u1"), ("v", "<i4", (faces.shape[1],))])
                farr = np.empty(len(faces), dtype=frec)
                farr["n"] = faces.shape[1]
                farr["v"] = faces
                f.write(farr.tobytes())


# ---------------------------------------------------------------------------
# Convenience wrappers
# ---------------------------------------------------------------------------

def write_mesh_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
                   colors: Optional[np.ndarray] = None,
                   normals: Optional[np.ndarray] = None) -> None:
    v = {"x": vertices[:, 0].astype(np.float32),
         "y": vertices[:, 1].astype(np.float32),
         "z": vertices[:, 2].astype(np.float32)}
    if normals is not None:
        v["nx"], v["ny"], v["nz"] = (normals[:, i].astype(np.float32) for i in range(3))
    if colors is not None:
        c = colors
        if c.dtype.kind == "f":
            c = np.clip(c * 255.0, 0, 255).astype(np.uint8)
        v["red"], v["green"], v["blue"] = c[:, 0], c[:, 1], c[:, 2]
    write_ply(path, v, faces)


def read_points_colors(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Point positions + colors (the io_utils.read_ply contract)."""
    d = read_ply(path)
    return d.positions, d.colors
