"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Builds happen at first use, never at import, into
``genome_assembler_tpu_torch/_build/`` (listed in ``.gitignore``); the
library name carries a hash of the source and flags, so an edited source
is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises RuntimeError if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put the CUDA toolkit on PATH); "
        "the port's CUDA kernels are built from csrc/ at first use"
    )


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if not already built) -> library path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        text = fh.read()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and ``dlopen`` ``csrc/<name>.cu``; cached per
    process."""
    return ctypes.CDLL(build(name))


@functools.lru_cache(maxsize=None)
def kmer_extract_fn():
    """The ``kmer_extract_launch`` C entry with its ctypes signature."""
    fn = load("kmer_extract").kmer_extract_launch
    fn.argtypes = [
        ctypes.c_void_p,  # packed codes
        ctypes.c_longlong,  # packed row stride (bytes)
        ctypes.c_void_p,  # invalid bits (may be NULL)
        ctypes.c_longlong,  # invalid row stride (bytes)
        ctypes.c_void_p,  # the batch's int32 flag (may be NULL)
        ctypes.c_void_p,  # int64 count of masked windows (may be NULL)
        ctypes.c_void_p,  # out limbs
        ctypes.c_longlong,  # batch rows
        ctypes.c_longlong,  # n_valid
        ctypes.c_int,  # read_len
        ctypes.c_int,  # k
        ctypes.c_int,  # n_limbs
        ctypes.c_int,  # reads per block
        ctypes.c_int,  # shared words for a block's packed codes
        ctypes.c_int,  # shared words for a block's invalid bits
        ctypes.c_longlong,  # dynamic shared memory (bytes)
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def pack_reads_fn():
    """The ``pack_reads_launch`` C entry (in the library of
    ``kmer_extract``) with its ctypes signature."""
    fn = load("kmer_extract").pack_reads_launch
    fn.argtypes = [
        ctypes.c_void_p,  # raw codes [rows, L] uint8
        ctypes.c_longlong,  # rows
        ctypes.c_int,  # read_len
        ctypes.c_void_p,  # packed codes out
        ctypes.c_void_p,  # invalid bits out
        ctypes.c_void_p,  # the batch's int32 flag out
        ctypes.c_void_p,  # int64 count of batches with an N (may be NULL)
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def count_insert_fn():
    """The ``count_insert_launch`` C entry (in the library of
    ``kmer_extract``) with its ctypes signature."""
    fn = load("kmer_extract").count_insert_launch
    fn.argtypes = [
        ctypes.c_void_p,  # keys [n] int64
        ctypes.c_void_p,  # weights [n] int32 (may be NULL)
        ctypes.c_longlong,  # n
        ctypes.c_void_p,  # table [slots] 16-byte slots
        ctypes.c_longlong,  # slots, a power of two
        ctypes.c_longlong,  # capacity
        ctypes.c_void_p,  # uint64 count of claimed slots
        ctypes.c_void_p,  # int32 overflow flag
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn
