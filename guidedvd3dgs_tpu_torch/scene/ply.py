"""Self-contained PLY IO, no plyfile/trimesh dependency.

The port's own copy of `guidedvd3dgs_tpu/scene/ply.py`. Two layouts:
  * point clouds (x,y,z[,nx,ny,nz][,red,green,blue]): `fetch_ply`/`store_ply`
  * Gaussian snapshots with the original 3DGS attribute list
    (x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..44,opacity,scale_0..2,rot_0..3),
    so snapshots are interchangeable between the two packages and the
    original.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from guidedvd3dgs_tpu_torch.utils.graphics import BasicPointCloud

_PLY_DTYPES = {
    "char": "i1",
    "uchar": "u1",
    "short": "i2",
    "ushort": "u2",
    "int": "i4",
    "uint": "u4",
    "float": "f4",
    "double": "f8",
    "int8": "i1",
    "uint8": "u1",
    "int16": "i2",
    "uint16": "u2",
    "int32": "i4",
    "uint32": "u4",
    "float32": "f4",
    "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY 'vertex' element into a dict of column arrays. Handles
    ascii and binary_little_endian, scalar properties only (list properties
    of non-vertex elements are skipped)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append(("list", " ".join(tokens[2:])))
                else:
                    cur[2].append((tokens[-1], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format {fmt}")

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                if name == "vertex":
                    raise ValueError("list properties on vertex not supported")
                break  # variable-size rows; stop (faces etc. unused)
            dtype = np.dtype([(p[0], "<" + p[1]) for p in props])
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(tuple(f.readline().split()))
                data = np.array(rows, dtype=dtype)
            else:
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(data[p])
        return out


def write_ply(path: str, columns: Dict[str, np.ndarray]):
    """Write a single binary 'vertex' element with float32 scalar
    properties (uchar for columns named red/green/blue)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = list(columns.keys())
    n = len(next(iter(columns.values())))
    fields = []
    for name in names:
        col = np.asarray(columns[name])
        if name in ("red", "green", "blue"):
            fields.append((name, "u1", col.astype(np.uint8)))
        else:
            fields.append((name, "f4", col.astype(np.float32)))

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    typenames = {"u1": "uchar", "f4": "float"}
    for name, t, _ in fields:
        header.append(f"property {typenames[t]} {name}")
    header.append("end_header\n")

    dtype = np.dtype([(name, "<" + t) for name, t, _ in fields])
    rec = np.empty(n, dtype=dtype)
    for name, _, col in fields:
        rec[name] = col

    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def fetch_ply(path: str) -> BasicPointCloud:
    """Load a point cloud ply -> BasicPointCloud with colors in [0,1]."""
    cols = read_ply(path)
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float64)
    if "red" in cols:
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1)
        rgb = rgb.astype(np.float64) / 255.0 if rgb.dtype != np.float32 else rgb.astype(np.float64)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
    else:
        rgb = np.full_like(pts, 0.5)
    if "nx" in cols:
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1).astype(np.float64)
    else:
        normals = np.zeros_like(pts)
    return BasicPointCloud(points=pts, colors=rgb, normals=normals)


def store_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """Write a colored point cloud (rgb in the 0..255 uint8 convention)."""
    normals = np.zeros_like(xyz)
    write_ply(
        path,
        {
            "x": xyz[:, 0],
            "y": xyz[:, 1],
            "z": xyz[:, 2],
            "nx": normals[:, 0],
            "ny": normals[:, 1],
            "nz": normals[:, 2],
            "red": rgb[:, 0],
            "green": rgb[:, 1],
            "blue": rgb[:, 2],
        },
    )


# ----------------------------------------------------------------------------
# Gaussian snapshot layout (the original 3DGS attribute list)
# ----------------------------------------------------------------------------


def save_gaussian_ply(path: str, params, active: np.ndarray):
    """Write the `active` rows of `params` (any object with xyz,
    features_dc, features_rest, opacity, scaling, rotation attributes
    numpy can convert) in the 3DGS attribute layout."""
    act = np.asarray(active)
    xyz = np.asarray(params.xyz)[act]
    fdc = np.asarray(params.features_dc)[act]  # (N, 1, 3)
    frest = np.asarray(params.features_rest)[act]  # (N, R, 3)
    opacity = np.asarray(params.opacity)[act]
    scaling = np.asarray(params.scaling)[act]
    rotation = np.asarray(params.rotation)[act]
    n = xyz.shape[0]

    cols = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    for i, name in enumerate(("nx", "ny", "nz")):
        cols[name] = np.zeros(n, np.float32)
    # 3DGS flattens features channel-major: transpose(1,2).flatten ->
    # (3, K) per point flattened row-major = channel-contiguous
    fdc_flat = fdc.transpose(0, 2, 1).reshape(n, -1)
    for i in range(fdc_flat.shape[1]):
        cols[f"f_dc_{i}"] = fdc_flat[:, i]
    frest_flat = frest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(frest_flat.shape[1]):
        cols[f"f_rest_{i}"] = frest_flat[:, i]
    cols["opacity"] = opacity[:, 0]
    for i in range(scaling.shape[1]):
        cols[f"scale_{i}"] = scaling[:, i]
    for i in range(rotation.shape[1]):
        cols[f"rot_{i}"] = rotation[:, i]
    write_ply(path, cols)


def load_gaussian_ply(path: str):
    """Read a Gaussian snapshot back into a dict of numpy arrays."""
    cols = read_ply(path)
    n = cols["x"].shape[0]
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], 1)
    opacity = cols["opacity"][:, None]

    fdc_names = sorted((k for k in cols if k.startswith("f_dc_")), key=lambda s: int(s[5:]))
    fdc = np.stack([cols[k] for k in fdc_names], 1).reshape(n, 3, -1).transpose(0, 2, 1)

    frest_names = sorted((k for k in cols if k.startswith("f_rest_")), key=lambda s: int(s[7:]))
    if frest_names:
        frest = np.stack([cols[k] for k in frest_names], 1).reshape(n, 3, -1).transpose(0, 2, 1)
    else:
        frest = np.zeros((n, 0, 3), np.float32)

    scale_names = sorted((k for k in cols if k.startswith("scale_")), key=lambda s: int(s[6:]))
    scaling = np.stack([cols[k] for k in scale_names], 1)
    rot_names = sorted((k for k in cols if k.startswith("rot_")), key=lambda s: int(s[4:]))
    rotation = np.stack([cols[k] for k in rot_names], 1)
    return {
        "xyz": xyz.astype(np.float32),
        "features_dc": fdc.astype(np.float32),
        "features_rest": frest.astype(np.float32),
        "opacity": opacity.astype(np.float32),
        "scaling": scaling.astype(np.float32),
        "rotation": rotation.astype(np.float32),
    }
