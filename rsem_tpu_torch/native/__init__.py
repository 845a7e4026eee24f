"""The C++ host sidecar of the hybrid and native EM backends.

Counterpart of rsem_tpu/native/__init__.py for suffstats.cpp (the BAM
ingest library, bamparse.cpp, is not ported yet). Three entry points, each
multithreaded C++ in float64: `native_conprb` (the reference's getConPrb /
getNoiseConPrb), `native_em_count_step` (one E-step over cached conprbs)
and `native_suffstats` (the sufficient statistics that
GenerativeModel.finish_round takes).

The library is built with g++ at first use into
`rsem_tpu_torch/_build/native-<hash of the source and flags>/` (listed in
.gitignore) and reused after; nothing is written beside the source. There
is no fallback: without g++, or if the build fails, the call raises.
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

import numpy as np

SRC = Path(__file__).resolve().with_name("suffstats.cpp")
BUILD_ROOT = SRC.parent.parent / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
LIB_NAME = "libsuffstats.so"

# argument types by letter: q int64, i int, d double, p pointer
_SIGNATURES = {
    "conprb": "q" + "p" * 11 + "qq" + "p" * 6 + "iiiid" + "i" * 7 + "p" * 9
              + "ipp",
    "em_count_step": "qpppppqippp",
    "suffstats": "q" + "p" * 12 + "qq" + "p" * 5 + "iiiid" + "i" * 6
                 + "p" * 6 + "ipppp",
}
_CTYPES = {"q": ctypes.c_int64, "i": ctypes.c_int, "d": ctypes.c_double,
           "p": ctypes.c_void_p}

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile suffstats.cpp with g++ unless this exact build exists
    already. Returns the library path; raises if g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the hybrid and native EM "
                           "backends build their C++ sidecar with it")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        res = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o",
                              str(tmp / LIB_NAME)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC.name}:\n{res.stdout}")
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / LIB_NAME, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded sidecar library (built on first use)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        for name, sig in _SIGNATURES.items():
            fn = getattr(L, name)
            fn.argtypes = [_CTYPES[c] for c in sig]
            fn.restype = None
        _lib = L
    return _lib


def default_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _ptr(arr: Optional[np.ndarray]):
    return None if arr is None else arr.ctypes.data


def _c(arr, dtype) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=dtype)


def _inputs(hits, reads, ref, model) -> dict:
    """Contiguous typed host arrays and the model's windows and tables."""
    spec = model.spec
    m1, m2 = (reads.mate1, reads.mate2) if spec.paired else (reads, None)
    max_len = m1.max_len if m2 is None else max(m1.max_len, m2.max_len)

    def padded(ra, field):
        if ra is None or (field == "quals" and not spec.has_qual):
            return None
        a = getattr(ra, field)
        return _c(np.pad(a, ((0, 0), (0, max_len - a.shape[1]))), np.uint8)

    glb, gub = model.gld_window
    if model.mld is not None:
        mlb, mub = model.mld_window
        mpdf, mcdf = model.mld.device_arrays(mlb, mub)
    else:
        mlb, mub = 0, 1
        mpdf = mcdf = np.zeros(2)
    gpdf, gcdf = model.gld.device_arrays(glb, gub)
    f64 = np.float64
    return dict(
        m1=m1, max_len=max_len,
        rid=_c(hits.rid, np.int32), sid=_c(hits.sid, np.int32),
        dir=_c(hits.dir, np.int8), pos=_c(hits.pos, np.int32),
        ins=_c(hits.insert_len, np.int32) if spec.paired else None,
        codes1=padded(m1, "codes"), quals1=padded(m1, "quals"),
        lens1=_c(m1.lens, np.int32),
        codes2=padded(m2, "codes"), quals2=padded(m2, "quals"),
        lens2=_c(m2.lens, np.int32) if m2 is not None else None,
        ref_codes=_c(ref.codes, np.uint8), ref_offsets=_c(ref.offsets,
                                                          np.int64),
        tot_len=_c(ref.tot_len, np.int32), full_len=_c(ref.full_len,
                                                       np.int32),
        glb=glb, gub=gub, mlb=mlb, mub=mub,
        gpdf=_c(gpdf, f64), gcdf=_c(gcdf, f64), mpdf=_c(mpdf, f64),
        mcdf=_c(mcdf, f64), rspd_pdf=_c(model.rspd.pdf, f64),
        rspd_cdf=_c(model.rspd.cdf, f64),
        pro_len=100 if spec.has_qual else model.pro.pro_len,
    )


def native_conprb(hits, reads, ref, model, n_threads: Optional[int] = None):
    """Exact float64 per-hit conprb and noise conprb (reference: getConPrb
    / getNoiseConPrb). Returns (conprb [H] f64, ncp [N] f64)."""
    spec = model.spec
    t = _inputs(hits, reads, ref, model)
    f64 = np.float64
    lq = _c(reads.lq if spec.paired else t["m1"].lq, np.uint8)
    pro = _c(model.pro.p.reshape(-1), f64)
    npro = _c(model.npro.p.reshape(-1), f64)
    mw = _c(model.mw, f64)
    mask_start = _c(ref.mask_start, np.int32)
    out_conprb = np.zeros(hits.n_hits)
    out_ncp = np.zeros(t["m1"].n)
    lib().conprb(
        hits.n_hits, _ptr(t["rid"]), _ptr(t["sid"]), _ptr(t["dir"]),
        _ptr(t["pos"]), _ptr(t["ins"]), _ptr(t["codes1"]), _ptr(t["quals1"]),
        _ptr(t["lens1"]), _ptr(t["codes2"]), _ptr(t["quals2"]),
        _ptr(t["lens2"]), t["m1"].n, t["max_len"], _ptr(lq),
        _ptr(t["ref_codes"]), _ptr(t["ref_offsets"]), _ptr(t["tot_len"]),
        _ptr(t["full_len"]), _ptr(mask_start), int(spec.has_qual),
        int(spec.paired), int(spec.est_rspd), spec.B, spec.probF,
        t["pro_len"], spec.seed_len, t["glb"], t["gub"], t["mlb"], t["mub"],
        int(spec.use_mld_single), _ptr(t["gpdf"]), _ptr(t["gcdf"]),
        _ptr(t["mpdf"]), _ptr(t["mcdf"]), _ptr(t["rspd_pdf"]),
        _ptr(t["rspd_cdf"]), _ptr(pro), _ptr(npro), _ptr(mw),
        n_threads or default_threads(), _ptr(out_conprb), _ptr(out_ncp))
    return out_conprb, out_ncp


def native_em_count_step(hits, conprb, ncp, theta, M: int,
                         n_threads: Optional[int] = None):
    """One E-step over cached conprbs on the host: (frac [H], frac_noise
    [N], counts [M+1]) in float64, counts[0] without N0."""
    offsets = _c(hits.read_offsets, np.int64)
    sid = _c(hits.sid, np.int32)
    conprb, ncp, theta = (_c(x, np.float64) for x in (conprb, ncp, theta))
    out_frac = np.zeros(hits.n_hits)
    out_frac_noise = np.zeros(hits.n_reads)
    out_counts = np.zeros(M + 1)
    lib().em_count_step(
        hits.n_reads, _ptr(offsets), _ptr(sid), _ptr(conprb), _ptr(ncp),
        _ptr(theta), M, n_threads or default_threads(), _ptr(out_frac),
        _ptr(out_frac_noise), _ptr(out_counts))
    return out_frac, out_frac_noise, out_counts


def native_suffstats(hits, frac_hit, frac_noise, reads, ref, model,
                     n_threads: Optional[int] = None):
    """The suff dict GenerativeModel.finish_round takes, from float32
    posteriors (frac_hit [H], frac_noise [N])."""
    spec = model.spec
    t = _inputs(hits, reads, ref, model)
    out_pro = np.zeros(t["pro_len"] * 25)
    out_npro = np.zeros(500 if spec.has_qual else 5)
    out_gld = np.zeros(t["gub"] - t["glb"])
    out_rspd = np.zeros(spec.B)
    frac_hit = _c(frac_hit, np.float32)
    frac_noise = _c(frac_noise, np.float32)
    lib().suffstats(
        hits.n_hits, _ptr(t["rid"]), _ptr(t["sid"]), _ptr(t["dir"]),
        _ptr(t["pos"]), _ptr(t["ins"]), _ptr(frac_hit), _ptr(t["codes1"]),
        _ptr(t["quals1"]), _ptr(t["lens1"]), _ptr(t["codes2"]),
        _ptr(t["quals2"]), _ptr(t["lens2"]), t["m1"].n, t["max_len"],
        _ptr(frac_noise), _ptr(t["ref_codes"]), _ptr(t["ref_offsets"]),
        _ptr(t["tot_len"]), _ptr(t["full_len"]), int(spec.has_qual),
        int(spec.paired), int(spec.est_rspd), spec.B, spec.probF,
        t["pro_len"], t["glb"], t["gub"], t["mlb"], t["mub"],
        int(spec.use_mld_single), _ptr(t["gpdf"]), _ptr(t["gcdf"]),
        _ptr(t["mpdf"]), _ptr(t["mcdf"]), _ptr(t["rspd_pdf"]),
        _ptr(t["rspd_cdf"]), n_threads or default_threads(), _ptr(out_pro),
        _ptr(out_npro), _ptr(out_gld), _ptr(out_rspd))
    suff = {
        "pro": out_pro.reshape(t["pro_len"], 5, 5),
        "npro": out_npro.reshape(100, 5) if spec.has_qual else out_npro,
    }
    if spec.paired:
        suff["gld"] = out_gld
    if spec.est_rspd:
        suff["rspd"] = out_rspd
    return suff
