"""Mesh / point-cloud IO (port of mpmavatar_tpu/utils/io.py; the
reference's utils/general_utils.py:318-349).

Every writer takes numpy arrays or tensors (of any device); every reader
returns numpy.  ``read_obj`` parses with the port's native library
(``mpmavatar_tpu_torch.native``) and falls back to pure-Python parsing,
saying once why, where the library cannot be built or loaded."""

from __future__ import annotations

import logging

import numpy as np
import torch

_log = logging.getLogger(__name__)
_native_failure_logged = False


def as_numpy(a, dtype=None):
    """A numpy array of ``a`` (a tensor goes to the host first)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _read_obj_py(path):
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                p = line.split()
                faces.append(tuple(int(x.split("/")[0]) - 1 for x in p[1:4]))
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32) if faces else
            np.zeros((0, 3), np.int32))


def read_obj(path):
    """(verts (V, 3) float32, faces (F, 3) int32) of an OBJ file."""
    global _native_failure_logged
    from .. import native
    try:
        native.build()
    except (OSError, RuntimeError) as exc:   # no g++, or it failed
        if not _native_failure_logged:
            _log.warning("native OBJ parser unavailable (%s); parsing in "
                         "Python", exc)
            _native_failure_logged = True
        return _read_obj_py(path)
    return native.fast_obj.read_obj(path)


def write_obj(path, verts, faces=None, extra_lines=None):
    with open(path, "w") as f:
        for v in as_numpy(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if extra_lines:
            f.writelines(extra_lines)
        if faces is not None:
            for fc in as_numpy(faces):
                f.write(f"f {fc[0] + 1} {fc[1] + 1} {fc[2] + 1}\n")


_PLY_DTYPES = {"float": "<f4", "float32": "<f4", "double": "<f8",
               "float64": "<f8", "int": "<i4", "int32": "<i4",
               "uint": "<u4", "uint32": "<u4", "short": "<i2",
               "ushort": "<u2", "char": "<i1", "uchar": "<u1",
               "int8": "<i1", "uint8": "<u1"}


def _read_ply_raw(path):
    """Minimal self-contained PLY reader (ascii + binary_little_endian):
    returns {element_name: structured array or list-prop dict}."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype or ("list", ...))])
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elements.append((name, int(cnt), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(
                        (parts[4], ("list", _PLY_DTYPES[parts[2]],
                                    _PLY_DTYPES[parts[3]])))
                else:
                    elements[-1][2].append((parts[2],
                                            _PLY_DTYPES[parts[1]]))
            elif line == "end_header":
                break
        out = {}
        for name, cnt, props in elements:
            has_list = any(isinstance(d, tuple) for _, d in props)
            if not has_list:
                dt = np.dtype([(n, d) for n, d in props])
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(cnt)]
                    arr = np.zeros(cnt, dt)
                    for i, row in enumerate(rows):
                        for (n, _), v in zip(props, row):
                            arr[n][i] = float(v)
                else:
                    arr = np.frombuffer(f.read(cnt * dt.itemsize), dt,
                                        count=cnt)
                out[name] = arr
            else:
                # single list property (face vertex_indices)
                lname, (_, cdt, idt) = props[0]
                lists = []
                if fmt == "ascii":
                    for _ in range(cnt):
                        row = f.readline().split()
                        k = int(row[0])
                        lists.append([int(x) for x in row[1:1 + k]])
                else:
                    cs = np.dtype(cdt).itemsize
                    it = np.dtype(idt).itemsize
                    for _ in range(cnt):
                        k = int(np.frombuffer(f.read(cs), cdt)[0])
                        lists.append(np.frombuffer(f.read(k * it), idt,
                                                   count=k))
                out[name] = {lname: lists}
        return out


def _write_ply_binary(path, name, arr, face_lists=None):
    """Write one structured-array element (+ optional face list) as
    binary_little_endian PLY."""
    inv = {v: k for k, v in _PLY_DTYPES.items()}
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element {name} {len(arr)}\n".encode())
        for n in arr.dtype.names:
            t = inv[arr.dtype[n].newbyteorder("<").str]
            f.write(f"property {t} {n}\n".encode())
        if face_lists is not None:
            f.write(f"element face {len(face_lists)}\n".encode())
            f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(arr.tobytes())
        if face_lists is not None:
            for fl in face_lists:
                f.write(np.uint8(len(fl)).tobytes())
                f.write(np.asarray(fl, "<i4").tobytes())


def read_ply(path):
    data = _read_ply_raw(path)
    v = data["vertex"]
    verts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    if "face" in data:
        faces = np.asarray(list(data["face"].values())[0],
                           dtype=np.int32)
    else:
        faces = np.zeros((0, 3), np.int32)
    return verts, faces


def write_ply_gaussians(path, xyz, features_dc, features_rest, opacity,
                        scaling, rotation, binding=None):
    """3DGS checkpoint PLY layout (scene/gaussian_model.py:229-264).

    f_dc/f_rest follow the reference's channel-major flattening
    (``transpose(1, 2).flatten`` of (N, coeffs, 3) SH features,
    gaussian_model.py:262) so PLYs interchange with the reference and
    standard 3DGS viewers."""
    n = xyz.shape[0]
    f_dc = as_numpy(features_dc)
    f_dc = (f_dc.transpose(0, 2, 1) if f_dc.ndim == 3 else f_dc
            ).reshape(n, -1)
    f_rest = as_numpy(features_rest)
    f_rest = (f_rest.transpose(0, 2, 1) if f_rest.ndim == 3 else f_rest
              ).reshape(n, -1)
    attrs = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scaling.shape[1])]
             + [f"rot_{i}" for i in range(rotation.shape[1])])
    if binding is not None:
        attrs += ["binding_0"]
    dtype = [(a, "f4") for a in attrs]
    rows = np.concatenate(
        [as_numpy(xyz), np.zeros((n, 3), np.float32), f_dc, f_rest,
         as_numpy(opacity).reshape(n, 1), as_numpy(scaling),
         as_numpy(rotation)]
        + ([as_numpy(binding, np.float32).reshape(n, 1)]
           if binding is not None else []), axis=1)
    el = np.empty(n, dtype=dtype)
    for i, a in enumerate(attrs):
        el[a] = rows[:, i]
    _write_ply_binary(path, "vertex", el)


def read_ply_gaussians(path):
    """Inverse of write_ply_gaussians: undoes the reference's
    channel-major f_dc/f_rest flattening back to (N, coeffs, 3)
    (gaussian_model.py:301-316)."""
    v = _read_ply_raw(path)["vertex"]
    names = list(v.dtype.names)
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    f_dc = np.stack([v[n] for n in names if n.startswith("f_dc_")],
                    1).astype(np.float32)
    f_dc = f_dc.reshape(len(xyz), 3, -1).transpose(0, 2, 1)
    f_rest_names = sorted([n for n in names if n.startswith("f_rest_")],
                          key=lambda s: int(s.split("_")[-1]))
    f_rest = (np.stack([v[n] for n in f_rest_names], 1).astype(np.float32)
              if f_rest_names else np.zeros((len(xyz), 0), np.float32))
    f_rest = f_rest.reshape(len(xyz), 3, -1).transpose(0, 2, 1)
    opacity = np.asarray(v["opacity"], np.float32)
    scaling = np.stack([v[n] for n in names if n.startswith("scale_")],
                       1).astype(np.float32)
    rotation = np.stack([v[n] for n in names if n.startswith("rot_")],
                        1).astype(np.float32)
    binding = (np.asarray(v["binding_0"], np.int32)
               if "binding_0" in names else None)
    return dict(xyz=xyz, features_dc=f_dc, features_rest=f_rest,
                opacity=opacity, scaling=scaling, rotation=rotation,
                binding=binding)
