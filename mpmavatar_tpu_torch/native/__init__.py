"""Native (C++) host components, built with g++ at first use (the port's
own copy of mpmavatar_tpu/native):

* ``fast_obj`` -- an OBJ mesh parser;
* ``knn`` -- KD-tree KNN queries and the mean squared distance to the 3
  nearest neighbours (the reference's CUDA ``simple-knn`` distCUDA2).

The sources are ``native/src/*.cpp``.  The library goes to the
git-ignored ``mpmavatar_tpu_torch/build/`` under a name keyed by the
sources and flags, so an edited source rebuilds and an unchanged one loads
at once.  Nothing is built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# a portable baseline (no -march=native): a library copied to another
# machine must not stop on an instruction that machine lacks
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp")
_lib = None


def _sources():
    return [SRC / f for f in ("fast_obj.cpp", "knn3.cpp")]


def build() -> Path:
    """Compile the library unless the one for the current sources exists;
    returns its path."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    target = BUILD_DIR / f"libmpmnative-{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / target.name
        out = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp_lib),
             *[str(s) for s in _sources()]], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC}:\n{out.stdout}"
                               f"{out.stderr}")
        os.replace(tmp_lib, target)   # atomic: concurrent builds agree
    return target


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.obj_count.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.obj_count.restype = ctypes.c_int
    lib.obj_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.obj_read.restype = ctypes.c_int
    lib.knn3.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                         ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p]
    lib.knn3.restype = ctypes.c_int
    lib.mean_dist2_knn3.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p]
    lib.mean_dist2_knn3.restype = ctypes.c_int
    _lib = lib
    return lib


class fast_obj:
    @staticmethod
    def read_obj(path):
        """(verts (V, 3) float32, faces (F, 3) int32) of an OBJ file."""
        lib = _load()
        nv, nf = ctypes.c_int64(), ctypes.c_int64()
        if lib.obj_count(str(path).encode(), ctypes.byref(nv),
                         ctypes.byref(nf)):
            raise IOError(f"cannot open {path}")
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        if lib.obj_read(str(path).encode(), verts.ctypes.data,
                        faces.ctypes.data):
            raise IOError(f"cannot read {path}")
        return verts, faces


class knn:
    @staticmethod
    def query(points, queries, k):
        """The k nearest of ``points`` to each query: (dist2 (m, k),
        idx (m, k))."""
        lib = _load()
        points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        queries = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
        m = len(queries)
        dist2 = np.empty((m, k), np.float32)
        idx = np.empty((m, k), np.int32)
        if lib.knn3(points.ctypes.data, len(points), queries.ctypes.data,
                    m, k, dist2.ctypes.data, idx.ctypes.data):
            raise RuntimeError("knn3 failed")
        return dist2, idx

    @staticmethod
    def mean_dist2_3nn(points):
        """Mean squared distance of each point to its 3 nearest others
        (distCUDA2)."""
        lib = _load()
        points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        out = np.empty(len(points), np.float32)
        if lib.mean_dist2_knn3(points.ctypes.data, len(points),
                               out.ctypes.data):
            raise RuntimeError("mean_dist2_knn3 failed")
        return out
