"""ctypes bindings for the native C++ read loader (native/ga_io.cpp).

Loads reads (plain lines or FASTA) straight into a [B, L] uint8 code batch
via mmap + single-pass encode — the production-scale path for reference
component C1 (SURVEY.md §2.1). Builds the shared library on first use if
the toolchain is available; callers fall back to the pure-Python parser
(cli.read_sequences) when the library can't load or reads are ragged.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(_DIR, "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libga_io.so")

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_NATIVE_DIR, "ga_io.cpp")
    stale = not os.path.exists(_LIB_PATH) or (
        os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    )
    if stale:
        # make's own dependency check also catches this, but calling it
        # only when needed keeps import cheap on read-only installs.
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.ga_scan_reads.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ga_scan_reads.restype = ctypes.c_int
    lib.ga_encode_reads.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.ga_encode_reads.restype = ctypes.c_int
    lib.ga_decode_seq.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_char_p,
    ]
    lib.ga_decode_seq.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def load_reads(path: str) -> np.ndarray | None:
    """Parse + encode a uniform-length read file natively.

    Handles plain-line, FASTA, and FASTQ inputs; ambiguous bases (Ns)
    encode to INVALID_CODE and their windows are masked downstream.
    Returns [B, L] uint8 codes, or None when the native path doesn't apply
    (library unavailable or ragged reads — callers then use the Python
    parser, which raises precise errors).
    """
    lib = _load()
    if lib is None:
        return None
    num = ctypes.c_int64()
    rlen = ctypes.c_int64()
    bad = ctypes.c_int32()
    rc = lib.ga_scan_reads(
        path.encode(), ctypes.byref(num), ctypes.byref(rlen), ctypes.byref(bad)
    )
    if rc != 0 or num.value == 0 or rlen.value <= 0:
        return None
    out = np.empty((num.value, rlen.value), dtype=np.uint8)
    rc = lib.ga_encode_reads(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num.value,
        rlen.value,
    )
    if rc != 0:
        return None
    return out


def decode_seq_native(codes: np.ndarray) -> str | None:
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    buf = ctypes.create_string_buffer(codes.size)
    lib.ga_decode_seq(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), codes.size, buf
    )
    return buf.raw.decode()
