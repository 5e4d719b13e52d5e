"""Canonical k-mer extraction: the CUDA kernel and its plain torch version.

Counterpart of ``genome_assembler_tpu/ops/kmer_jax.py`` (the XLA chain
``unpack_codes`` -> ``unpack_invalid_mask`` -> ``extract_kmers`` ->
``extract_canonical_flat``) and ``ops/kmer_pallas.py`` (the TPU kernel
``_kernel`` that the XLA chain twins). Both reference branches of
``models.pipeline._extract_keys`` produce the same keys bit for bit; so
do both versions here:

  * ``extract_canonical_flat`` -- the wrapper. A CUDA tensor launches the
    hand-written kernel ``csrc/kmer_extract.cu`` (or raises); a CPU tensor
    runs ``extract_canonical_flat_ref``. It counts its kernel launches in
    ``extract_canonical_flat.launches``.
  * ``extract_canonical_flat_ref`` -- the plain torch version, used by the
    CPU tests, CPU runs, and the on-card comparison in ``chip_smoke.py``.

Kernel note (details in the .cu source): it replaces
``genome_assembler_tpu/ops/kmer_pallas.py::_kernel``; it is bound by
device-memory bytes (8 * n_limbs bytes out per window, about L/4 + L/8
bytes in per read). The packed row's own bit stream, complemented, is
the reverse strand of every window, and the forward strand is the same
bits with their 2-bit pairs reversed (a bit reversal and a swap), so a
window costs a fixed few dozen operations whatever k is and nothing
is carried from window to window. A block stages the packed rows of a
few whole reads in shared memory and writes their keys as one
contiguous span of 16-byte stores. ``launch_plan`` sizes the block from
L and k; a shape whose rows do not fit a block's shared memory raises.

``pack_on_device`` makes the kernel's inputs from raw one-byte codes on
the device, the bytes of ``utils.dna.pack_codes`` / ``pack_invalid_mask``,
and finds the batch's ambiguous bases in the same pass (its flag): on a
CUDA tensor the hand-written ``pack_reads_kernel`` (in
``csrc/kmer_extract.cu``, one library with the extraction), on a CPU
tensor its plain version, ``pack_codes_device`` and
``pack_invalid_device``. The streamed counters upload raw codes and pack
them there; the extraction kernel reads the flag and takes the invalid
bits only in a batch that has one.

Output contract: ``[B * (L-k+1), n_limbs]`` int64 limbs (``utils.keys``
layout), row-major over (read, window). Windows of rows >= ``n_valid``
and windows that touch an ambiguous base are the sentinel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.keys import INT64_MIN, SENTINEL, lsr, n_limbs
from ..utils.metrics import HBM_PEAK_BYTES_S

# The kernel's operation bound: no integer rate is published for the H100,
# so the float32 rate outside the tensor cores stands in (half of it would
# not change which bound is the larger), at a fixed count a window limb.
INT_OPS_PER_S = 67e12
OPS_PER_WINDOW_LIMB = 8  # 2 shifts, 2 ors, mask, complement, compare, select


def unpack_codes(packed: torch.Tensor, read_len: int) -> torch.Tensor:
    """[B, ceil(L/4)] packed bytes -> [B, L] uint8 2-bit codes
    (``utils.dna.pack_codes`` layout)."""
    parts = [(packed >> (2 * i)) & 3 for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(packed.shape[0], -1)[:, :read_len]


def unpack_invalid_mask(packed: torch.Tensor, read_len: int) -> torch.Tensor:
    """[B, ceil(L/8)] packed bits -> [B, L] bool
    (``utils.dna.pack_invalid_mask`` layout, little bit order)."""
    bits = [(packed >> i) & 1 for i in range(8)]
    bad = torch.stack(bits, dim=-1).reshape(packed.shape[0], -1)
    return bad[:, :read_len].bool()


def pack_codes_device(codes: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 codes on any device -> [B, ceil(L/4)] uint8, 4 bases a
    byte: ``utils.dna.pack_codes`` in plain torch ops, byte for byte (an
    ambiguous base packs as its low 2 bits)."""
    b, length = codes.shape
    pad = (-length) % 4
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    quads = (codes & 3).reshape(b, -1, 4)
    out = quads[:, :, 0]
    for j in range(1, 4):
        out = out | (quads[:, :, j] << (2 * j))
    return out.contiguous()


def pack_invalid_device(codes: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 codes on any device -> [B, ceil(L/8)] uint8 bits of the
    ambiguous bases (codes > 3): ``utils.dna.pack_invalid_mask`` in plain
    torch ops, except that a batch without any gives zeros, not None (the
    extracted keys are the same, and the device is not read to find out)."""
    b, length = codes.shape
    bad = (codes > 3).to(torch.uint8)
    pad = (-length) % 8
    if pad:
        bad = torch.nn.functional.pad(bad, (0, pad))
    octs = bad.reshape(b, -1, 8)
    out = octs[:, :, 0]
    for j in range(1, 8):
        out = out | (octs[:, :, j] << j)
    return out.contiguous()


# groups of 8 codes a pack launch takes at most (the pack kernel's
# thread indices are 32-bit)
PACK_MAX_GROUPS = 0x7FFFFFFF


class PackedReads(NamedTuple):
    """A batch packed on its device: the extraction kernel's inputs."""

    packed: torch.Tensor  # [B, ceil(L/4)] uint8, ``utils.dna.pack_codes``
    inv: torch.Tensor  # [B, ceil(L/8)] uint8, ``pack_invalid_mask`` or zeros
    flag: torch.Tensor  # 0-d int32: non-zero iff any code is > 3


def pack_on_device(codes: torch.Tensor,
                   batches: torch.Tensor | None = None) -> PackedReads:
    """Raw [B, L] uint8 codes on their device -> ``PackedReads``, in one
    pass: the packed codes, the invalid bits (zeros without an ambiguous
    base) and the batch's flag, all on the device; the host waits for
    nothing. ``batches`` (an int64 0-d counter on the same device, or
    None) gains 1 if the batch holds an ambiguous base.

    A CUDA tensor launches ``pack_reads_kernel`` (``csrc/kmer_extract.cu``)
    on the current stream (counted in ``pack_on_device.launches``) or
    raises; a CPU tensor runs the plain version, ``pack_codes_device`` and
    ``pack_invalid_device``.
    """
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be a 2-D uint8 tensor, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    _check_counter(batches, torch.int64, codes.device, "batches")
    if codes.device.type == "cpu":
        flag = (codes > 3).any().to(torch.int32)
        if batches is not None:
            batches += flag
        return PackedReads(pack_codes_device(codes),
                           pack_invalid_device(codes), flag)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    b, length = codes.shape
    if b * ((length + 7) // 8) > PACK_MAX_GROUPS:
        raise ValueError(f"{b} reads of {length} bases pass the pack "
                         f"kernel's {PACK_MAX_GROUPS} groups of 8 codes")
    from ._build import pack_reads_fn

    out = PackedReads(
        codes.new_empty((b, (length + 3) // 4)),
        codes.new_empty((b, (length + 7) // 8)),
        torch.empty((), dtype=torch.int32, device=codes.device),
    )
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = pack_reads_fn()(
            codes.data_ptr(), b, length, out.packed.data_ptr(),
            out.inv.data_ptr(), out.flag.data_ptr(),
            None if batches is None else batches.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"pack_reads launch failed: CUDA error {err} "
                           f"({b} reads of {length} bases)")
    pack_on_device.launches += 1
    return out


pack_on_device.launches = 0


def _check_counter(t, dtype, device, what) -> None:
    """A one-element counter or flag on ``device`` (or None)."""
    if t is not None and (t.dtype != dtype or t.numel() != 1
                          or t.device != device):
        raise ValueError(f"{what} must be one {dtype} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def extract_canonical_codes_ref(
    codes: torch.Tensor,
    k: int,
    n_valid: int | None = None,
    bad: torch.Tensor | None = None,
) -> torch.Tensor:
    """[B, L] raw uint8 codes -> [B*(L-k+1), n_limbs] canonical limbs.

    Plain torch, mirroring ``kmer_jax.extract_kmers``: a code > 3 (an
    ambiguous base, ``INVALID_CODE``) or a ``bad`` flag masks every window
    that touches it; rows >= ``n_valid`` are masked too.
    """
    b, length = codes.shape
    wc = length - k + 1
    nl = n_limbs(k)
    dev = codes.device
    window_bad = torch.zeros((b, wc), dtype=torch.bool, device=dev)
    top = 2 * (k - 1)
    zeros = torch.zeros((b, wc), dtype=torch.int64, device=dev)
    fh, fl, rh, rl = zeros, zeros, zeros, zeros
    for j in range(k):
        base = codes[:, j : j + wc].to(torch.int64)
        window_bad = window_bad | (base > 3)
        if bad is not None:
            window_bad = window_bad | bad[:, j : j + wc]
        base = base & 3
        comp = 3 - base
        if nl == 1:
            # values stay below 2^62: plain signed shifts are exact
            fl = (fl << 2) | base
            rl = (rl >> 2) | (comp << top)
        else:
            fh = (fh << 2) | lsr(fl, 62)
            fl = (fl << 2) | base
            rl = lsr(rl, 2) | (rh << 62)
            rh = lsr(rh, 2)
            if top >= 64:
                rh = rh | (comp << (top - 64))
            else:
                rl = rl | (comp << top)
    if nl == 1:
        out = torch.minimum(fl, rl)[..., None]
    else:
        # unsigned 128-bit compare: high parts are < 2^62 (signed is
        # exact); low parts compare unsigned via the sign flip
        flx, rlx = fl ^ INT64_MIN, rl ^ INT64_MIN
        pick_fwd = (fh < rh) | ((fh == rh) & (flx <= rlx))
        out = torch.stack(
            [torch.where(pick_fwd, fh, rh), torch.where(pick_fwd, flx, rlx)],
            dim=-1,
        )
    if n_valid is not None:
        rows = torch.arange(b, device=dev)[:, None] >= n_valid
        window_bad = window_bad | rows
    out = out.masked_fill(window_bad[..., None], SENTINEL)
    return out.reshape(b * wc, nl)


def extract_canonical_flat_ref(
    packed: torch.Tensor,
    read_len: int,
    k: int,
    n_valid: int | None = None,
    inv_bits: torch.Tensor | None = None,
    flag: torch.Tensor | None = None,
    masked: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of the kernel: packed codes (+ packed invalid
    bits, read only where ``flag`` is None or non-zero) -> [B*(L-k+1),
    n_limbs] canonical limbs; ``masked`` gains the windows of rows <
    n_valid that the invalid bits mask. Nothing waits for the device."""
    if inv_bits is not None and flag is not None:
        inv_bits = inv_bits * (flag != 0)
    bad = None if inv_bits is None else unpack_invalid_mask(inv_bits, read_len)
    out = extract_canonical_codes_ref(
        unpack_codes(packed, read_len), k, n_valid, bad
    )
    if masked is not None and inv_bits is not None:
        # in rows < n_valid only the invalid bits make a sentinel key
        rows = packed.shape[0] if n_valid is None else n_valid
        masked += (out[: rows * (read_len - k + 1), 0] == SENTINEL).sum()
    return out


def _check_args(packed, read_len, k, n_valid, inv_bits, flag=None,
                masked=None) -> int:
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(
            f"packed codes must be a 2-D uint8 tensor, got {packed.dtype} "
            f"{tuple(packed.shape)}"
        )
    b = packed.shape[0]
    if not 2 <= k <= 63:
        raise ValueError(f"k must be in [2, 63], got {k}")
    if not k <= read_len:
        raise ValueError(f"k={k} exceeds read_len={read_len}")
    if packed.shape[1] != (read_len + 3) // 4:
        raise ValueError(
            f"packed codes have {packed.shape[1]} bytes per read, expected "
            f"ceil({read_len}/4) = {(read_len + 3) // 4}"
        )
    if not packed.is_contiguous():
        raise ValueError("packed codes must be contiguous")
    if n_valid is not None and not 0 <= n_valid <= b:
        raise ValueError(f"n_valid={n_valid} outside [0, {b}]")
    if inv_bits is not None:
        if inv_bits.dtype != torch.uint8 or tuple(inv_bits.shape) != (
            b, (read_len + 7) // 8
        ):
            raise ValueError(
                f"invalid bits must be uint8 [{b}, {(read_len + 7) // 8}], "
                f"got {inv_bits.dtype} {tuple(inv_bits.shape)}"
            )
        if inv_bits.device != packed.device:
            raise ValueError("invalid bits and codes lie on different devices")
        if not inv_bits.is_contiguous():
            raise ValueError("invalid bits must be contiguous")
    _check_counter(flag, torch.int32, packed.device, "flag")
    _check_counter(masked, torch.int64, packed.device, "masked")
    return b


# Launch geometry of csrc/kmer_extract.cu (the .cu entry checks the same).
BLOCK_WINDOWS = 4096  # windows a block of 256 threads takes, about
MAX_READS_PER_BLOCK = 256
CODE_PAD_WORDS = 4  # words past a shared span's data that a window may touch
INV_PAD_WORDS = 2
SHARED_DEFAULT = 48 * 1024  # dynamic shared memory a block gets without opt-in
SHARED_MAX = 232_448  # 227 KB, the most a Hopper block can opt in to


class LaunchPlan(NamedTuple):
    """How ``csrc/kmer_extract.cu`` cuts a batch into blocks."""

    reads_per_block: int  # R whole reads a block, even
    code_words: int  # 32-bit shared words for a block's packed codes
    inv_words: int  # 32-bit shared words for a block's invalid bits
    shared_bytes: int  # dynamic shared memory of a block


def launch_plan(read_len: int, k: int) -> LaunchPlan:
    """The kernel's launch geometry for reads of ``read_len`` bases.

    A block takes R whole reads, about ``BLOCK_WINDOWS`` windows, and
    copies their packed rows and invalid bits, one contiguous span of
    the input each, into shared memory as aligned 32-bit words: the
    span's bytes, one word for its misalignment, and the words the last
    window's funnel shifts may touch. R is even so that a block's span of
    the output starts on a 16-byte boundary, and it shrinks while the
    spans would pass the 48 KB a block gets by default; only when even
    two reads pass it does the block opt in to more, up to 227 KB.
    Raises ValueError when two reads' rows do not fit a block.
    """
    wc = read_len - k + 1
    code_bytes, inv_bytes = (read_len + 3) // 4, (read_len + 7) // 8

    def words(reads):
        return (
            (reads * code_bytes + 3) // 4 + 1 + CODE_PAD_WORDS,
            (reads * inv_bytes + 3) // 4 + 1 + INV_PAD_WORDS,
        )

    reads = min(MAX_READS_PER_BLOCK, max(2, (-(-BLOCK_WINDOWS // wc) + 1) & ~1))
    while reads > 2 and 4 * sum(words(reads)) > SHARED_DEFAULT:
        reads = (reads // 2 + 1) & ~1
    shared = 4 * sum(words(reads))
    if shared > SHARED_MAX:
        raise ValueError(
            f"read_len={read_len}, k={k}: two reads' packed rows need "
            f"{shared} bytes of shared memory, a block has {SHARED_MAX}"
        )
    return LaunchPlan(reads, *words(reads), shared)


def extract_canonical_flat(
    packed: torch.Tensor,
    read_len: int,
    k: int,
    n_valid: int | None = None,
    inv_bits: torch.Tensor | None = None,
    flag: torch.Tensor | None = None,
    masked: torch.Tensor | None = None,
) -> torch.Tensor:
    """[B, ceil(L/4)] packed reads -> [B*(L-k+1), n_limbs] canonical limbs.

    ``flag`` (the batch's 0-d int32 from ``pack_on_device``): the invalid
    bits are read only where it is non-zero, so a batch without an
    ambiguous base costs what one without bits does; without a flag they
    are always read. ``masked`` (a 0-d int64 counter) gains the windows of
    rows < n_valid that the invalid bits mask, on the device.

    On a CUDA tensor this launches ``csrc/kmer_extract.cu`` on the current
    stream (and raises if the shape does not fit the kernel, or the build
    or the launch fails); on a CPU tensor it runs
    :func:`extract_canonical_flat_ref`. Any B is accepted.
    """
    _check_args(packed, read_len, k, n_valid, inv_bits, flag, masked)
    if packed.device.type == "cpu":
        return extract_canonical_flat_ref(packed, read_len, k, n_valid,
                                          inv_bits, flag, masked)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    return launch_kernel(
        packed, read_len, k, n_valid, inv_bits, launch_plan(read_len, k),
        flag, masked,
    )


def kernel_bound_ms(
    b: int, read_len: int, k: int, with_inv: bool
) -> tuple[float, str, int]:
    """The least time the card could take for one extraction of ``b``
    reads: the larger of the bytes over the memory rate (packed codes and
    invalid bits read once, key limbs written once) and the integer
    operations over their rate. Returns (ms, ``"bytes"`` or
    ``"operations"``, bytes)."""
    nl = n_limbs(k)
    windows = b * (read_len - k + 1)
    nbytes = windows * nl * 8 + b * ((read_len + 3) // 4)
    if with_inv:
        nbytes += b * ((read_len + 7) // 8)
    bytes_ms = nbytes / HBM_PEAK_BYTES_S * 1e3
    ops_ms = windows * nl * OPS_PER_WINDOW_LIMB / INT_OPS_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes
    return ops_ms, "operations", nbytes


def launch_kernel(packed, read_len, k, n_valid, inv_bits, plan: LaunchPlan,
                  flag=None, masked=None):
    """Launch ``csrc/kmer_extract.cu`` with ``plan`` on checked CUDA
    arguments (the wrapper's second half). Counts the launch in
    ``extract_canonical_flat.launches``."""
    from ._build import kmer_extract_fn

    fn = kmer_extract_fn()
    b = packed.shape[0]
    nl = n_limbs(k)
    wc = read_len - k + 1
    out = torch.empty((b * wc, nl), dtype=torch.int64, device=packed.device)
    if b == 0:
        return out
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(
            packed.data_ptr(),
            packed.stride(0),
            None if inv_bits is None else inv_bits.data_ptr(),
            0 if inv_bits is None else inv_bits.stride(0),
            None if flag is None else flag.data_ptr(),
            None if masked is None else masked.data_ptr(),
            out.data_ptr(),
            b,
            b if n_valid is None else n_valid,
            read_len,
            k,
            nl,
            *plan,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"kmer_extract launch failed: CUDA error {err} "
            f"(read_len={read_len}, k={k}, {plan})"
        )
    extract_canonical_flat.launches += 1
    return out


extract_canonical_flat.launches = 0
