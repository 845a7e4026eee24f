"""Build and load the hand-written CUDA kernels (csrc/*.cu).

No counterpart in rsem_tpu (Pallas kernels compile inside jit). Every
source under csrc/ is compiled by `nvcc` for sm_90a, all at once (one
process per source, started together), and linked into one shared library
with a plain C interface that ctypes loads. The library goes into
`rsem_tpu_torch/_build/<hash of sources and flags>/` (listed in
.gitignore), so a checkout builds it on first use and reuses it after.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas=-v"]
LIB_NAME = "librsem_tpu_torch_kernels.so"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
_F64 = ctypes.c_double
SIGNATURES = {
    "rsem_gather_sum": [_P, _I64, _P, _I64, _I32, _P, _P],
    "rsem_scatter_add": [_P, _I64, _I32, _P, _I32, _P, _P],
    "rsem_preidx": [_P, _I64, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P,
                    _I64, _I32, _I32, _P, _P],
    "rsem_theta_rounds": [_P, _P, _P, _P, _P, _I64, _I64, _F64, _P, _P, _P,
                          _P, _P, _I32, _P],
    "rsem_theta_partial": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P],
    "rsem_theta_finish": [_I64, _F64, _P, _P, _P, _P, _P, _P, _P],
    "rsem_estep_stats": [_P, _P, _P, _P, _P, _P, _P, _I64, _P, _I32, _P, _P,
                         _P, _P, _I32, _F32, _I32, _I32, _P, _P, _P, _P, _P,
                         _P],
    "rsem_gibbs_sweep": [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I64,
                         _I64, _U32, _U32, _U32, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc output of the last build in this process


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link the shared library unless
    this exact build exists already. Returns the library path."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    srcs, _ = _sources()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        cc = nvcc()
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            cmd = [cc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"--- {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + ":\n" + "\n".join(logs))
        link = [cc, *ARCH, "-shared", *(str(o) for _s, o, _p in procs),
                "-o", str(tmp / LIB_NAME)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        logs.append(f"--- link\n{res.stdout}")
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / LIB_NAME, out)
        build_log = "\n".join(logs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(L, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        L.rsem_error_string.argtypes = [ctypes.c_int]
        L.rsem_error_string.restype = ctypes.c_char_p
        _lib = L
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().rsem_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of `t`'s device, as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
