"""The card's peaks and the least time of the extraction kernel's work.

The work is counted from the reads and the keys, not from what the
kernel reads: the reads in as 2-bit codes (4 bases a byte) and one key a
window out, ``n_limbs(k)`` int64 limbs of up to 31 bases each. A kernel
that packs the reads itself, or reads them again, is held to the same
bytes. At 262,144 reads of 100 bases and k=31: 6,553,600 B in and
146,800,640 B out, 153,354,240 B, 0.0458 ms.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s, at the
# card's full power limit of 700 W.
HBM_PEAK_BYTES_S = 3.35e12

EXTRACT_KERNEL = "extract_canonical_kernel"


def n_limbs(k: int) -> int:
    """int64 limbs a key of k bases takes, 31 bases a limb."""
    if not 1 <= k <= 63:
        raise ValueError(f"k must be in [1, 63], got {k}")
    return -(-k // 31)


def extract_bytes(reads: int, read_len: int, k: int) -> int:
    """Bytes the extraction of ``reads`` reads must move at the least."""
    windows = reads * (read_len - k + 1)
    return reads * ((read_len + 3) // 4) + windows * n_limbs(k) * 8


def extract_bound_s(reads: int, read_len: int, k: int) -> float:
    """The least seconds of that extraction on one card: bytes over the
    memory rate (its integer operations take a twentieth of that)."""
    return extract_bytes(reads, read_len, k) / HBM_PEAK_BYTES_S
