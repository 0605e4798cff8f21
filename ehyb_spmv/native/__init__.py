"""Native (C++) components, loaded via ctypes.

The reference's one true native dependency is the prebuilt ``libmtmetis.a``
multilevel k-way graph partitioner (``mtmetis.h:150``, called at
``reordering.c:126-139, 280-293``).  This package ships its own C++
implementation (``partition.cpp``: heavy-edge-matching coarsening + greedy
growing initial partition + boundary FM refinement) compiled on first use with
``g++`` into ``native/build/``, keyed by source and host.  No pybind11 — plain C ABI + ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
#: Build outputs (gitignored).  Each library's file name carries a hash of its
#: source and of the compiler's resolved target flags, so a checkout copied to
#: another host never loads a library built for a different CPU or from an
#: older source.
_BUILD_DIR = os.path.join(_HERE, "build")
_CXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
              "-std=c++17"]
_lock = threading.Lock()
_lib = None
_iolib = None
_host_key = None


class NativeBuildError(RuntimeError):
    pass


def _target_flags() -> bytes:
    """What ``-march=native`` resolves to on this host (part of the key)."""
    global _host_key
    if _host_key is None:
        proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ target query failed ({proc.returncode}):\n"
                f"{proc.stderr.decode(errors='replace')}")
        _host_key = proc.stdout
    return _host_key


def library_path(src_name: str) -> str:
    """Path of the shared library built from ``src_name`` on this host."""
    with open(os.path.join(_HERE, src_name), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src)
    h.update(" ".join(_CXX_FLAGS).encode())
    h.update(_target_flags())
    stem = os.path.splitext(src_name)[0]
    return os.path.join(_BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _compile(src_name: str, force: bool = False) -> str:
    """Compile one C++ source into a shared library keyed by source and host
    (see :func:`library_path`); reuses an existing build of the same key."""
    lib = library_path(src_name)
    with _lock:
        if not force and os.path.exists(lib):
            return lib
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = ["g++", *_CXX_FLAGS, "-o", tmp, os.path.join(_HERE, src_name)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic against concurrent test workers
        return lib


def build_native(force: bool = False) -> str:
    """Compile partition.cpp (cached per source and host)."""
    return _compile("partition.cpp", force)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    lib = ctypes.CDLL(path)
    lib.ehyb_partition_kway.restype = ctypes.c_longlong
    lib.ehyb_partition_kway.argtypes = [
        ctypes.c_int,                                    # n vertices
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # xadj [n+1]
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # adjncy [m]
        ctypes.c_int,                                    # nparts
        ctypes.c_double,                                 # imbalance (e.g. 1.03)
        ctypes.c_int,                                    # seed
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # out: part [n]
    ]
    _lib = lib
    return lib


def kway_partition_native(xadj: np.ndarray, adjncy: np.ndarray, n_parts: int,
                          imbalance: float = 1.03, seed: int = 0) -> np.ndarray:
    """k-way partition labels via the C++ partitioner.  Returns int32 [n].

    API shape mirrors ``MTMETIS_PartGraphKway`` (``mtmetis.h:150``): CSR
    adjacency in, per-vertex part id out; the return value is the edge cut.
    """
    lib = _load()
    xadj = np.ascontiguousarray(xadj, dtype=np.int32)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int32)
    n = xadj.shape[0] - 1
    out = np.empty(n, dtype=np.int32)
    cut = lib.ehyb_partition_kway(n, xadj, adjncy, int(n_parts),
                                  float(imbalance), int(seed), out)
    if cut < 0:
        raise RuntimeError(f"native partitioner failed (code {cut})")
    return out


# ---------------------------------------------------------------------------
# Native relaxed-body packer (converter; see relaxpack.cpp).
# ---------------------------------------------------------------------------

_packlib = None


def _load_pack():
    global _packlib
    if _packlib is not None:
        return _packlib
    lib = ctypes.CDLL(_compile("relaxpack.cpp"))
    lib.ehyb_pack_relaxed.restype = ctypes.c_longlong
    lib.ehyb_pack_relaxed.argtypes = [
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # pair
        np.ctypeslib.ndpointer(np.int16, flags="C"),     # lane
        np.ctypeslib.ndpointer(np.int16, flags="C"),     # slot
        np.ctypeslib.ndpointer(np.int16, flags="C"),     # cls
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # order (pair-grouped)
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # out: step
    ]
    _packlib = lib
    return lib


def pack_relaxed_native(pair: np.ndarray, lane: np.ndarray, slot: np.ndarray,
                        cls: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Relaxed SELL-body step assignment via the unbounded-color class-aware
    greedy (relaxpack.cpp::ehyb_pack_relaxed).  ``order`` must be grouped by
    pair.  Returns int64 per-entry step within its pair (never spills)."""
    lib = _load_pack()
    n = pair.shape[0]
    pair = np.ascontiguousarray(pair, dtype=np.int64)
    lane = np.ascontiguousarray(lane, dtype=np.int16)
    slot = np.ascontiguousarray(slot, dtype=np.int16)
    cls = np.ascontiguousarray(cls, dtype=np.int16)
    order = np.ascontiguousarray(order, dtype=np.int64)
    out = np.empty(n, dtype=np.int32)
    rc = lib.ehyb_pack_relaxed(n, pair, lane, slot, cls, order, out)
    if rc < 0:
        raise RuntimeError(f"native relaxed packer failed (code {rc})")
    return out.astype(np.int64)


# ---------------------------------------------------------------------------
# Native DIA extractor (converter hot path; see diaextract.cpp).
# ---------------------------------------------------------------------------

_dialib = None


def _load_dia():
    global _dialib
    if _dialib is not None:
        return _dialib
    lib = ctypes.CDLL(_compile("diaextract.cpp"))
    lib.ehyb_dia_count.restype = ctypes.c_longlong
    lib.ehyb_dia_count.argtypes = [
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # row
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # col
        ctypes.c_longlong, ctypes.c_longlong,            # lo, hi
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # out: counts
    ]
    lib.ehyb_dia_fill.restype = ctypes.c_longlong
    lib.ehyb_dia_fill.argtypes = [
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # row
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # col
        np.ctypeslib.ndpointer(np.float64, flags="C"),   # val
        ctypes.c_longlong, ctypes.c_longlong,            # lo, hi
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # off_rank
        ctypes.c_longlong,                               # dim_r
        np.ctypeslib.ndpointer(np.float64, flags="C"),   # out: dia (K*dim_r)
        np.ctypeslib.ndpointer(np.uint8, flags="C"),     # out: keep
    ]
    _dialib = lib
    return lib


def dia_count_native(row: np.ndarray, col: np.ndarray, lo: int,
                     hi: int) -> np.ndarray:
    """Per-offset entry counts over the band [lo, hi] (diaextract.cpp pass 1).

    Returns int64 counts of length (hi - lo + 1); counts[d - lo] is the
    number of entries with col - row == d.
    """
    lib = _load_dia()
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    counts = np.zeros(hi - lo + 1, dtype=np.int64)
    rc = lib.ehyb_dia_count(row.shape[0], row, col, int(lo), int(hi), counts)
    if rc < 0:
        raise RuntimeError(f"native dia count failed (code {rc})")
    return counts


def dia_fill_native(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                    lo: int, hi: int, off_rank: np.ndarray, dim_r: int,
                    k: int):
    """Scatter-add in-band entries into the (k, dim_r) dense diagonal block
    (diaextract.cpp pass 2).  Accumulates f64; returns (dia, keep_mask)."""
    lib = _load_dia()
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=np.float64)
    off_rank = np.ascontiguousarray(off_rank, dtype=np.int32)
    dia = np.zeros(max(k, 1) * dim_r, dtype=np.float64)
    keep = np.empty(row.shape[0], dtype=np.uint8)
    kept = lib.ehyb_dia_fill(row.shape[0], row, col, val, int(lo), int(hi),
                             off_rank, int(dim_r), dia, keep)
    if kept < 0:
        raise RuntimeError(f"native dia fill failed (code {kept})")
    return dia[:k * dim_r].reshape(k, dim_r), keep.view(bool)


# ---------------------------------------------------------------------------
# Native RCM ordering (order-phase hot path; see rcm.cpp).
# ---------------------------------------------------------------------------

_rcmlib = None


def _load_rcm():
    global _rcmlib
    if _rcmlib is not None:
        return _rcmlib
    lib = ctypes.CDLL(_compile("rcm.cpp"))
    lib.ehyb_rcm.restype = ctypes.c_longlong
    lib.ehyb_rcm.argtypes = [
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # xadj [n+1]
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # adjncy [m]
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # out: new_to_old [n]
    ]
    lib.ehyb_adjacency.restype = ctypes.c_longlong
    lib.ehyb_adjacency.argtypes = [
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # row [nnz]
        np.ctypeslib.ndpointer(np.int64, flags="C"),     # col [nnz]
        ctypes.c_longlong,                               # n vertices
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # out: xadj [n+1]
        np.ctypeslib.ndpointer(np.int32, flags="C"),     # out: adjncy [2*nnz]
    ]
    _rcmlib = lib
    return lib


def adjacency_native(row: np.ndarray, col: np.ndarray, n: int):
    """Symmetrized dedup'd CSR adjacency (see rcm.cpp) — bit-identical to
    ``partition.py::adjacency_csr``.  Returns (xadj int32 [n+1], adjncy)."""
    lib = _load_rcm()
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    xadj = np.empty(n + 1, dtype=np.int32)
    adjncy = np.empty(max(2 * row.shape[0], 1), dtype=np.int32)
    sz = lib.ehyb_adjacency(row.shape[0], row, col, int(n), xadj, adjncy)
    if sz < 0:
        raise RuntimeError(f"native adjacency failed (code {sz})")
    return xadj, adjncy[:sz].copy()


def rcm_native(xadj: np.ndarray, adjncy: np.ndarray) -> np.ndarray:
    """Level-set pseudo-RCM over a CSR adjacency (see rcm.cpp).

    Bit-identical to the NumPy formulation in ``core/ordering.py::rcm_order``
    (equivalence pinned by tests), so cached artifacts keyed on the ordering
    stay valid.  Returns int64 ``new_to_old``.
    """
    lib = _load_rcm()
    xadj = np.ascontiguousarray(xadj, dtype=np.int32)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int32)
    n = xadj.shape[0] - 1
    out = np.empty(n, dtype=np.int64)
    rc = lib.ehyb_rcm(n, xadj, adjncy, out)
    if rc < 0:
        raise RuntimeError(f"native rcm failed (code {rc})")
    return out


# ---------------------------------------------------------------------------
# Native mtx entry parser (data-loader; see mtxparse.cpp).
# ---------------------------------------------------------------------------

def _load_io():
    global _iolib
    if _iolib is not None:
        return _iolib
    lib = ctypes.CDLL(_compile("mtxparse.cpp"))
    lib.ehyb_parse_entries.restype = ctypes.c_longlong
    lib.ehyb_parse_entries.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
    ]
    _iolib = lib
    return lib


def parse_entries_native(body: bytes, n_entries: int, has_value: bool):
    """Parse `.mtx` coordinate entries with the C++ scanner.

    Returns (row, col, val) 1-based int64/int64/float64 arrays of length
    exactly ``n_entries``.  Raises ValueError on malformed/miscounted input.
    """
    lib = _load_io()
    row = np.empty(n_entries, dtype=np.int64)
    col = np.empty(n_entries, dtype=np.int64)
    val = np.empty(n_entries if has_value else 1, dtype=np.float64)
    n = lib.ehyb_parse_entries(body, len(body), 3 if has_value else 2,
                               n_entries, row, col, val)
    if n < 0:
        raise ValueError(f"native mtx parse failed (code {n})")
    if n != n_entries:
        raise ValueError(f"expected {n_entries} entries, parsed {n}")
    if not has_value:
        val = np.ones(n_entries, dtype=np.float64)
    return row, col, val
