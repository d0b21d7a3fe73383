"""Native host-side I/O (C++, ctypes-bound).

The reference's host layer is C++ (relate_lib text parsers, htslib
binary decode); this package is its counterpart here: flat
columnar decoders compiled to ``libcolate_io.so`` and exposed through a
minimal C ABI.  Loading is best-effort — if the shared library is
missing we try one quiet in-tree build, and on any failure every
consumer falls back to the pure-Python decoders so the framework stays
functional on toolchain-less hosts.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libcolate_io.so")
_lib = None
_tried = False


_SOURCES = ("io.cpp", "em.cpp", "hts.cpp", "cond.cpp", "la.cpp")
# headers compiled into the TUs above (staleness check only)
_HEADERS = ("cram.hpp",)


def _build() -> bool:
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC", *srcs, "-o", _SO,
        "-lz", "-lpthread",
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        return r.returncode == 0 and os.path.exists(_SO)
    except Exception:
        return False


def load():
    """ctypes handle to the native library, or None.

    COLATE_NATIVE_SO points at an alternative build (e.g. the
    ASan/UBSan library from tools/native_sanitize.sh)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = os.environ.get("COLATE_NATIVE_SO", _SO)
    if so == _SO and (
        not os.path.exists(_SO)
        or os.path.getmtime(_SO)
        < max(
            os.path.getmtime(os.path.join(_HERE, s))
            for s in _SOURCES + _HEADERS
        )
    ):
        if not _build():
            if os.environ.get("COLATE_NATIVE_REQUIRED"):
                raise RuntimeError("native build failed and is required")
            print(
                "colate_tpu: native io build unavailable; using Python decoders",
                file=sys.stderr,
            )
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        if os.environ.get("COLATE_NATIVE_REQUIRED"):
            raise
        return None
    lib.cn_mut_read.restype = ctypes.c_void_p
    lib.cn_mut_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.cn_mut_n.restype = ctypes.c_int64
    lib.cn_mut_n.argtypes = [ctypes.c_void_p]
    lib.cn_mut_col.restype = ctypes.c_void_p
    lib.cn_mut_col.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.cn_mut_free.argtypes = [ctypes.c_void_p]
    lib.cn_colatein_read.restype = ctypes.c_void_p
    lib.cn_colatein_read.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int
    ]
    lib.cn_colatein_n.restype = ctypes.c_int64
    lib.cn_colatein_n.argtypes = [ctypes.c_void_p]
    lib.cn_colatein_col.restype = ctypes.c_void_p
    lib.cn_colatein_col.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.cn_colatein_free.argtypes = [ctypes.c_void_p]
    P = ctypes.c_void_p
    lib.cn_join_tmptmp.restype = ctypes.c_void_p
    lib.cn_join_tmptmp.argtypes = (
        [ctypes.c_int, P, P]          # n_chr, chrom blob, chrom offsets
        + [P] * 6                     # mut: off, pos, ab, ae, anc, der
        + [P] * 5 + [ctypes.c_int64] + [P] * 3 + [ctypes.c_int64]  # target
        + [P] * 5 + [ctypes.c_int64] + [P] * 3 + [ctypes.c_int64]  # reference
        + [ctypes.c_double, ctypes.c_int64]  # ref_age, bases per block
    )
    lib.cn_join_n.restype = ctypes.c_int64
    lib.cn_join_n.argtypes = [ctypes.c_void_p]
    lib.cn_join_num_blocks.restype = ctypes.c_int64
    lib.cn_join_num_blocks.argtypes = [ctypes.c_void_p]
    lib.cn_join_col.restype = ctypes.c_void_p
    lib.cn_join_col.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.cn_join_free.argtypes = [ctypes.c_void_p]
    lib.cn_bin_analytic.restype = None
    lib.cn_bin_analytic.argtypes = (
        [ctypes.c_int64] + [P] * 5           # n, ab, ae, ws, wn, blk
        + [ctypes.c_int64, ctypes.c_int, P]  # num_blocks, nbins, edges
        + [ctypes.c_double, ctypes.c_double] # age, bin C
        + [P] * 4                            # output histograms
    )
    lib.cn_mut_prefilter.restype = ctypes.c_void_p
    lib.cn_mut_prefilter.argtypes = (
        [ctypes.c_int, P, P]                 # n_chr, mut path blob+offsets
        + [P, P, P, P]                       # tmask blob/off, rmask blob/off
        + [ctypes.c_double]                  # age
        + [ctypes.c_char_p, ctypes.c_int]    # errbuf
    )
    lib.cn_prefilter_free.argtypes = [ctypes.c_void_p]
    lib.cn_tmptmp_join_bin.restype = ctypes.c_void_p
    lib.cn_tmptmp_join_bin.argtypes = (
        [ctypes.c_void_p]                    # prefilter handle (consumed)
        + [P] * 5 + [ctypes.c_int64, P]      # target cols, n, segments
        + [P] * 5 + [ctypes.c_int64, P]      # reference cols, n, segments
        + [ctypes.c_double, ctypes.c_int64]  # ref_age, bases per block
        + [ctypes.c_int, P]                  # nbins, edges
        + [ctypes.c_double, ctypes.c_double] # age, bin C
    )
    lib.cn_tmptmp_fused_stream.restype = ctypes.c_void_p
    lib.cn_tmptmp_fused_stream.argtypes = (
        [ctypes.c_void_p]                    # prefilter handle (consumed)
        + [ctypes.c_char_p, ctypes.c_char_p] # target/reference paths
        + [P, P]                             # chrom name blob + offsets
        + [ctypes.c_double, ctypes.c_int64]  # ref_age, bases per block
        + [ctypes.c_int, P]                  # nbins, edges
        + [ctypes.c_double, ctypes.c_double] # age, bin C
        + [ctypes.c_char_p, ctypes.c_int]    # errbuf
    )
    lib.cn_fused_num_blocks.restype = ctypes.c_int64
    lib.cn_fused_num_blocks.argtypes = [ctypes.c_void_p]
    lib.cn_fused_num_sites.restype = ctypes.c_int64
    lib.cn_fused_num_sites.argtypes = [ctypes.c_void_p]
    lib.cn_fused_hist.restype = ctypes.c_void_p
    lib.cn_fused_hist.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.cn_fused_free.argtypes = [ctypes.c_void_p]
    lib.cn_em_run.restype = None
    lib.cn_em_run.argtypes = (
        [P, ctypes.c_int, P]                 # epochs, E, init_rates
        + [P, P, ctypes.c_int, ctypes.c_int] # sc, nc, B, nbins
        + [P, P]                             # t ages, k epoch indices
        + [ctypes.c_int, ctypes.c_int]       # max_iter, min_iter
        + [ctypes.c_double, ctypes.c_double] # conv_ratio, rate_floor
        + [P, P, P]                          # out rates, logl, iters
    )
    lib.cn_cond_chrom.restype = None
    lib.cn_cond_chrom.argtypes = (
        [ctypes.c_int64] * 3                 # T, M, N
        + [P, P, P, P]                       # parent, blen, factors, blocks
        + [P, ctypes.c_int64, P, ctypes.c_int64]  # focal, n, cond, n
        + [P, ctypes.c_int64]                # group_of_hap, G
        + [P, ctypes.c_int64, P, ctypes.c_int64]  # epochs E, epochs_focal F
        + [P, P, P]                          # sample_ages|NULL, num, denom
    )
    lib.cn_cond_chrom_fast.restype = None
    lib.cn_cond_chrom_fast.argtypes = (
        [ctypes.c_int64] * 3                 # T, M, N
        + [P, P, P, P]                       # parent, blen, factors, blocks
        + [P, ctypes.c_int64, P, ctypes.c_int64]  # focal, n, cond, n
        + [P, ctypes.c_int64]                # group_of_hap, G
        + [P, ctypes.c_int64, P, ctypes.c_int64]  # epochs E, epochs_focal F
        + [P, P]                             # num, denom (f64)
    )
    lib.cn_bam_open.restype = ctypes.c_void_p
    lib.cn_bam_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.cn_bam_contig.restype = ctypes.c_int
    lib.cn_bam_contig.argtypes = (
        [ctypes.c_void_p, ctypes.c_char_p]
        + [P, ctypes.c_int64, P, ctypes.c_int64]  # ref, anc genomes
        + [P, ctypes.c_int64]                     # queries
        + [P, P, P, P]                            # claimed, counts, cov x2
        + [ctypes.c_char_p, ctypes.c_int]
    )
    lib.cn_bam_close.argtypes = [ctypes.c_void_p]
    lib.cn_bcf_read.restype = ctypes.c_void_p
    lib.cn_bcf_read.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.cn_bcf_n.restype = ctypes.c_int64
    lib.cn_bcf_n.argtypes = [ctypes.c_void_p]
    lib.cn_bcf_meta.restype = ctypes.c_int64
    lib.cn_bcf_meta.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cn_bcf_col.restype = ctypes.c_void_p
    lib.cn_bcf_col.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.cn_bcf_free.argtypes = [ctypes.c_void_p]
    lib.cn_anc_read.restype = ctypes.c_void_p
    lib.cn_anc_read.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int
    ]
    lib.cn_anc_n.restype = ctypes.c_int64
    lib.cn_anc_n.argtypes = [ctypes.c_void_p]
    lib.cn_anc_nhap.restype = ctypes.c_int64
    lib.cn_anc_nhap.argtypes = [ctypes.c_void_p]
    lib.cn_anc_col.restype = ctypes.c_void_p
    lib.cn_anc_col.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.cn_anc_free.argtypes = [ctypes.c_void_p]
    lib.cn_tree_coords.restype = ctypes.c_int
    lib.cn_tree_coords.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, P, P, P, P
    ]
    lib.cn_children.restype = None
    lib.cn_children.argtypes = [ctypes.c_int64, ctypes.c_int64, P, P]
    lib.cn_tree_populate_sorted.restype = None
    lib.cn_tree_populate_sorted.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        P, P, P, P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, P, P,
    ]
    lib.cn_la_accumulate.restype = None
    lib.cn_la_accumulate.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, P, P, P, P, P, P, P, P,
        ctypes.c_int64, ctypes.c_int32, P, P,
    ]
    _lib = lib
    return _lib


def col_array(lib, getter, handle, col, dtype):
    """Copy native column `col` out as a numpy array of `dtype`.

    One memcpy straight out of the native buffer (ctypes.string_at would
    materialise an intermediate Python bytes object — a second copy and
    GIL-bound allocation on the multi-MB blob columns)."""
    import numpy as np

    nb = ctypes.c_int64()
    ptr = getter(handle, col, ctypes.byref(nb))
    n = nb.value
    if n < 0:
        raise ValueError(f"bad native column id {col}")
    if n == 0:
        return np.zeros(0, dtype)
    src = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(n,)
    )
    out = np.empty(n, np.uint8)
    np.copyto(out, src)
    return out.view(dtype)
