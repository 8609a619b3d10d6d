"""Build, load and launch the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled to an object file by its own ``nvcc``
process (all started together), and the objects are linked into one
shared library with a plain C interface, bound with ``ctypes``.  The
library goes to ``mpmavatar_tpu_torch/build/`` (git-ignored) under a name
keyed by the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  The build runs at first use: nothing is
compiled or loaded when a module is imported.

Every launch goes through :func:`launch`, which raises on a nonzero
``cudaGetLastError()`` right after the launch and counts the launch per
kernel, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# IEEE sqrt and division (no --use_fast_math): parity with the plain
# versions needs them.  -Xptxas -v writes registers/spills to the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launch_counts()
_counts: dict = {}
_lib = None
_build_info: dict = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link every kernel source unless the library for the
    current sources exists; returns its path."""
    sources = _sources()
    target = BUILD_DIR / f"libmpm_kernels-{_digest()}.so"
    if target.exists():
        _build_info.update(path=str(target), seconds=0.0, cached=True)
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        (BUILD_DIR / "build.log").write_text(log)
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o",
             str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"link failed:\n{link.stdout}"
                                   f"{link.stderr}")
        os.replace(tmp_lib, target)   # atomic: concurrent builders agree
    _build_info.update(path=str(target), seconds=time.perf_counter() - t0,
                       cached=False, log=log)
    return target


def build_info() -> dict:
    """Path, seconds and (when built in this process) nvcc's log."""
    return dict(_build_info)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points: each returns cudaGetLastError() after its launch (the
# *_info queries: after reading the kernel's attributes)
_SIGNATURES = {
    "launch_cloth_stress": [_P] * 12 + [_I, _P],
    "launch_p2g": [_P] * 7 + [_I, _I, _I, _F, _F, _P, _P, _P, _P],
    "launch_g2p": [_P, _P, _I, _I, _F, _P, _P, _P, _P, _P],
    "launch_grid_pipeline": [_P] * 10 + [_F, _F, _I, _I, _I, _F, _I, _I,
                                         _I, _I, _I, _I, _P, _P],
    "launch_splat": [_P, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P],
    "launch_sand": [_P] * 6 + [_I] + [_P] * 4,
    "launch_composite": [_P, _P, _P, _I, _I, _I, _L, _P, _P],
    "launch_composite_bwd": [_P, _P, _P, _P, _I, _I, _I, _L, _P, _P],
    "cloth_stress_info": [_IP],
    "sand_stress_info": [_IP],
    "p2g_info": [_IP],
    "g2p_info": [_IP],
    "splat_info": [_I, _IP],
    "composite_info": [_I, _I, _IP],
    "composite_bwd_info": [_I, _I, _IP],
}


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.mpm_error_string.argtypes = [ctypes.c_int]
        lib.mpm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(kernel: str, symbol: str, *args) -> None:
    """Call C entry point ``symbol`` (which launches ``kernel`` on the
    stream passed as its last argument); raise if the launch failed."""
    lib = library()
    err = getattr(lib, symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{lib.mpm_error_string(err).decode()} ({err})")
    _counts[kernel] = _counts.get(kernel, 0) + 1


def reset_launch_counts() -> None:
    _counts.clear()


def launch_counts() -> dict:
    return dict(_counts)


def ptr(t) -> int | None:
    """Device pointer of a tensor for ctypes (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def kernel_attributes(symbol: str, *args) -> dict:
    """Registers and spilled bytes per thread, shared bytes per block and
    resident blocks per SM of a kernel as built, from its C query
    ``symbol`` (``cudaFuncGetAttributes`` and the occupancy API)."""
    lib = library()
    out = (ctypes.c_int * 4)()
    err = getattr(lib, symbol)(*args, out)
    if err != 0:
        raise RuntimeError(f"{symbol}: {lib.mpm_error_string(err).decode()}")
    return {"registers": out[0], "spill_bytes": out[1],
            "shared_bytes": out[2], "blocks_per_sm": out[3]}


def check_cuda(name: str, t, dtype=None):
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` (float32 default);
    return it contiguous."""
    dtype = torch.float32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    return t.contiguous()


def check_branch_counts(kernel: str, branch_counts) -> None:
    """Raise unless ``branch_counts`` is None or an int32 (2,) CUDA tensor
    (a tiled kernel's blocks counted by branch)."""
    if branch_counts is not None and (
            branch_counts.shape != (2,) or not branch_counts.is_cuda
            or branch_counts.dtype != torch.int32):
        raise ValueError(f"{kernel}: branch_counts must be an int32 (2,) "
                         "CUDA tensor")
