// The port's kernels for Hopper (sm_90a), one library: the canonical k-mer
// extraction, and below it the pack of raw reads that feeds it.
//
// Canonical k-mer extraction: every window built in a fixed number of
// steps from the packed row's own bits, one contiguous stream of 16-byte
// stores a block.
//
// Replaces the TPU kernel genome_assembler_tpu/ops/kmer_pallas.py::_kernel
// (and the XLA chain kmer_jax.unpack_codes -> unpack_invalid_mask ->
// extract_kmers -> extract_canonical_flat that it mirrors), in one pass:
//
//   in : packed 2-bit codes [B, ceil(L/4)] uint8 (base j in byte j/4 at
//        bit 2*(j%4), utils/dna.py pack_codes); optional invalid bits
//        [B, ceil(L/8)] uint8 (bit j%8 of byte j/8, pack_invalid_mask);
//        n_valid, L, k.
//   out: [B*(L-k+1), n_limbs] int64 canonical key limbs, row-major over
//        (read, window); n_limbs = 1 for k <= 31, 2 for 32 <= k <= 63
//        (utils/keys.py layout: one limb is the key value; two limbs are
//        (high 64 bits, low 64 bits ^ INT64_MIN)).
//   Windows of rows >= n_valid, and windows that touch an invalid bit,
//   get the sentinel limbs (INT64_MAX).
//   flag (optional): the batch's int32 flag from the pack (below), non-zero
//   iff the batch holds an invalid base. Each block reads it once: at 0 the
//   block takes the path without invalid bits and never reads them; set,
//   it stages and applies them, and adds the windows of its rows < n_valid
//   that they mask to the int64 counter `masked` (optional), one atomic a
//   block. Without a flag the invalid bits, where given, are always read.
//
// What bounds it on the card: device-memory bytes, almost all of them the
// key stream it writes (8*n_limbs bytes a window against about L/4 + L/8
// bytes a read). At 262,144 reads x 100 bp, k=31 that is 153.4 MB, 0.046 ms
// at 3.35 TB/s. A kernel that rebuilds every window from its k bases in a
// k-step loop is bound by its issue rate instead. What the design does
// about both:
//
//   * No loop over the k bases, and no state carried from window to window.
//     The packed row already is the reverse strand: base j sits at bits
//     2j, 2j+1 of the row's little-endian bit stream, which is where
//     rc = sum (3 - b_j) << 2(j - w) wants it, so rc(w) = ~(row >> 2w)
//     masked to 2k bits. The forward strand is the same 2k bits with the
//     order of the 2-bit pairs reversed: a bit reversal (brev), a swap of
//     neighbouring bits, a shift by 64 - 2k (128 - 2k for two limbs). A
//     window costs a few dozen operations whatever k is, and a window
//     touches an invalid base iff k bits of the invalid-bit row, taken at
//     bit w, are not all 0.
//   * One or two limbs by template: k <= 31 works on one 64-bit value a
//     strand, 32 <= k <= 63 on two.
//   * Each packed byte is read from device memory once, in aligned 32-bit
//     words: the packed rows (and invalid bits) of a block's R reads are
//     one contiguous span of the input, which the block copies into shared
//     memory as it lies, from the aligned word under its first byte. No
//     row is padded or realigned: a window's bits are 64 (128) bits of
//     that stream from bit 8*(row's byte offset) + 2w, taken out of three
//     (five) words by funnel shifts.
//   * Stores are coalesced 16-byte stores. With nothing carried between
//     windows any thread can take any window, so the block walks its span
//     of the output, [r0*wc*n_limbs, (r0+rows)*wc*n_limbs), in 16-byte
//     pairs (two one-limb windows, or one two-limb window), neighbouring
//     threads on neighbouring pairs; no key passes through shared memory.
//     R is even, so the span starts on a 16-byte boundary whatever wc is;
//     a span of odd length ends in one 8-byte store.
//
// The wrapper (ops/kmer_torch.py launch_plan) sizes R from L and k (about
// 4096 windows a block) and the shared spans; the entry point checks the
// plan again, opts in above 48 KB of shared memory, and refuses a shape
// whose rows do not fit a block's 227 KB. Output offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = INT64_MAX;
constexpr uint64_t kSignBit = 0x8000000000000000ull;
constexpr uint64_t kOddBits = 0x5555555555555555ull;
constexpr int kThreads = 256;
constexpr long long kMaxShared = 232448;  // 227 KB, the most a block can ask
// Words a shared span holds past its data, so that the aligned words
// under the last window's bits (five for two limbs, three for the invalid
// bits) stay inside it; what is read there is masked off.
constexpr int kCodePad = 4;
constexpr int kInvPad = 2;

// The launch plan, as ops/kmer_torch.py launch_plan computes it.
struct Plan {
  int reads_per_block;  // R, even
  int code_words;       // shared words for a block's packed codes
  int inv_words;        // shared words for a block's invalid bits
};

// Copy the aligned 32-bit words that cover src[0, nbytes) into dst, dst[0]
// being the word src lies in; returns src's byte offset in that word. The
// bytes read before src and past its end lie in the same aligned words as
// its first and last byte, so inside the allocation.
__device__ __forceinline__ int stage_span(uint32_t* dst,
                                          const uint8_t* __restrict__ src,
                                          int nbytes) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(src) & 3);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(src - mis);
  const int n = (mis + nbytes + 3) >> 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(words + i);
  return mis;
}

// 64 bits of a little-endian bit stream held in 32-bit words, from `bit`.
__device__ __forceinline__ uint64_t bits64(const uint32_t* words, int bit) {
  const uint32_t* p = words + (bit >> 5);
  const int sh = bit & 31;
  const uint32_t lo = __funnelshift_r(p[0], p[1], sh);
  const uint32_t hi = __funnelshift_r(p[1], p[2], sh);
  return ((uint64_t)hi << 32) | lo;
}

// The 32 2-bit pairs of v in reverse order.
__device__ __forceinline__ uint64_t reverse_pairs(uint64_t v) {
  v = __brevll(v);
  return ((v & kOddBits) << 1) | ((v >> 1) & kOddBits);
}

// Window: k bits of the invalid-bit stream from `bit`, any of them set.
__device__ __forceinline__ bool window_bad(const uint32_t* sinv, int bit,
                                           int k) {
  return (bits64(sinv, bit) & ((1ull << k) - 1)) != 0;
}

// Canonical key of the window whose 2k bits start at `bit` of the packed
// stream, k <= 31.
__device__ __forceinline__ long long key_one_limb(const uint32_t* scodes,
                                                  int bit, int k) {
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const uint64_t x = bits64(scodes, bit);
  const uint64_t rc = ~x & mask;
  const uint64_t fwd = reverse_pairs(x & mask) >> (64 - 2 * k);
  return (long long)(fwd < rc ? fwd : rc);
}

// Canonical key limbs (high, low ^ sign bit) of the window at `bit`,
// 32 <= k <= 63.
__device__ __forceinline__ longlong2 key_two_limbs(const uint32_t* scodes,
                                                   int bit, int k) {
  const uint64_t hmask = (1ull << (2 * k - 64)) - 1;
  const uint64_t xlo = bits64(scodes, bit);
  const uint64_t xhi = bits64(scodes, bit + 64) & hmask;
  const uint64_t rlo = ~xlo;
  const uint64_t rhi = ~xhi & hmask;
  // the 128-bit value (s_hi : s_lo) is the pairs of (xhi : xlo) reversed
  const uint64_t s_hi = reverse_pairs(xlo);
  const uint64_t s_lo = reverse_pairs(xhi);
  const int t = 128 - 2 * k;  // 2 .. 64
  const uint64_t flo = t == 64 ? s_hi : (s_lo >> t) | (s_hi << (64 - t));
  const uint64_t fhi = t == 64 ? 0ull : s_hi >> t;
  const bool pick_fwd = (fhi < rhi) || (fhi == rhi && flo <= rlo);
  return make_longlong2((long long)(pick_fwd ? fhi : rhi),
                        (long long)((pick_fwd ? flo : rlo) ^ kSignBit));
}

// Write the keys of a block's rows, [r0*wc*NL, (r0+rows)*wc*NL) of the
// output, from the staged streams; INV: apply the invalid bits. Returns
// the thread's windows of rows < n_valid that an invalid bit masked.
template <int NL, bool INV>
__device__ __forceinline__ unsigned write_keys(
    const uint32_t* scodes, const uint32_t* sinv, int code_bit0,
    int inv_bit0, long long* __restrict__ out, int64_t r0, int rows,
    int64_t n_valid, int wc, int k, int code_bytes, int inv_bytes) {
  unsigned masked = 0;
  // The block's keys are one contiguous span of the output, 16-byte
  // aligned because r0 is even: walk it in 16-byte pairs.
  const int n = rows * wc;  // windows of the block
  if constexpr (NL == 1) {
    long long* gdst = out + r0 * wc;
    for (int j = 2 * threadIdx.x; j < n; j += 2 * blockDim.x) {
      int r = j / wc;
      int w = j - r * wc;
      long long v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the second window of an odd span's last pair is not stored
        const bool live = (i == 0 || j + 1 < n) && r0 + r < n_valid;
        const bool bad =
            INV && live &&
            window_bad(sinv, inv_bit0 + 8 * r * inv_bytes + w, k);
        masked += bad;
        v[i] = !live || bad
                   ? kSentinel
                   : key_one_limb(
                         scodes, code_bit0 + 8 * r * code_bytes + 2 * w, k);
        if (++w == wc) {
          w = 0;
          ++r;
        }
      }
      if (j + 1 < n) {
        *reinterpret_cast<longlong2*>(gdst + j) = make_longlong2(v[0], v[1]);
      } else {
        gdst[j] = v[0];
      }
    }
  } else {
    longlong2* gdst = reinterpret_cast<longlong2*>(out + r0 * wc * 2);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int r = j / wc;
      const int w = j - r * wc;
      const bool live = r0 + r < n_valid;
      const bool bad =
          INV && live &&
          window_bad(sinv, inv_bit0 + 8 * r * inv_bytes + w, k);
      masked += bad;
      gdst[j] = !live || bad
                    ? make_longlong2(kSentinel, kSentinel)
                    : key_two_limbs(
                          scodes, code_bit0 + 8 * r * code_bytes + 2 * w, k);
    }
  }
  return masked;
}

template <int NL>
__global__ void __launch_bounds__(kThreads) extract_canonical_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ inv,
    const int* __restrict__ flag, unsigned long long* __restrict__ masked,
    long long* __restrict__ out, int64_t batch, int64_t n_valid, int read_len,
    int k, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* scodes = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sinv = scodes + plan.code_words;

  const int wc = read_len - k + 1;
  const int64_t r0 = (int64_t)blockIdx.x * plan.reads_per_block;
  const int rows = batch - r0 < plan.reads_per_block
                       ? (int)(batch - r0)
                       : plan.reads_per_block;
  // the same for every thread of the block: one 4-byte read of the flag
  const bool has_inv = inv != nullptr && (flag == nullptr || __ldg(flag) != 0);
  const int code_bytes = (read_len + 3) >> 2;  // a packed row
  const int inv_bytes = (read_len + 7) >> 3;

  // bit of the staged streams at which the block's first row starts
  const int code_bit0 =
      8 * stage_span(scodes, packed + r0 * code_bytes, rows * code_bytes);
  if (!has_inv) {
    __syncthreads();
    write_keys<NL, false>(scodes, sinv, code_bit0, 0, out, r0, rows, n_valid,
                          wc, k, code_bytes, inv_bytes);
    return;
  }
  const int inv_bit0 =
      8 * stage_span(sinv, inv + r0 * inv_bytes, rows * inv_bytes);
  __syncthreads();
  unsigned count = write_keys<NL, true>(scodes, sinv, code_bit0, inv_bit0,
                                        out, r0, rows, n_valid, wc, k,
                                        code_bytes, inv_bytes);
  if (masked == nullptr) return;
  // the block's total, in the first shared word once the streams are read
  count = __reduce_add_sync(0xffffffffu, count);
  __syncthreads();
  if (threadIdx.x == 0) scodes[0] = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(scodes, count);
  __syncthreads();
  if (threadIdx.x == 0 && scodes[0]) {
    atomicAdd(masked, (unsigned long long)scodes[0]);
  }
}

template <int NL>
cudaError_t launch(const void* packed, const void* inv, const void* flag,
                   void* masked, void* out, long long batch, long long n_valid,
                   int read_len, int k, Plan plan, long long shared_bytes,
                   cudaStream_t stream) {
  auto kernel = extract_canonical_kernel<NL>;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared_bytes);
    if (err != cudaSuccess) return err;
  }
  const long long blocks =
      (batch + plan.reads_per_block - 1) / plan.reads_per_block;
  kernel<<<(unsigned)blocks, kThreads, (size_t)shared_bytes, stream>>>(
      (const uint8_t*)packed, (const uint8_t*)inv, (const int*)flag,
      (unsigned long long*)masked, (long long*)out, batch, n_valid, read_len,
      k, plan);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported at once; a plan or a pointer the kernel cannot
// take is cudaErrorInvalidValue. Rows must be contiguous (stride = row
// bytes). inv may be null (no invalid bases); so may flag (the invalid
// bits always read) and masked (no count of masked windows).
extern "C" int kmer_extract_launch(
    const void* packed, long long packed_stride, const void* inv,
    long long inv_stride, const void* flag, void* masked, void* out,
    long long batch, long long n_valid, int read_len, int k, int n_limbs, int reads_per_block, int code_words,
    int inv_words, long long shared_bytes, void* stream) {
  if (k < 2 || k > 63 || read_len < k || batch < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_limbs != (k <= 31 ? 1 : 2)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const long long wc = read_len - k + 1;
  const Plan plan = {reads_per_block, code_words, inv_words};
  const long long code_bytes = (read_len + 3) / 4;
  const long long inv_bytes = (read_len + 7) / 8;
  if (packed_stride != code_bytes || (inv != nullptr && inv_stride != inv_bytes) ||
      reads_per_block < 2 || reads_per_block % 2 != 0 ||
      reads_per_block * wc > 0x3fffffffll ||
      code_words < (reads_per_block * code_bytes + 3) / 4 + 1 + kCodePad ||
      inv_words < (reads_per_block * inv_bytes + 3) / 4 + 1 + kInvPad ||
      shared_bytes < 4ll * (code_words + inv_words) ||
      shared_bytes > kMaxShared ||
      (batch + reads_per_block - 1) / reads_per_block > 0x7fffffffll ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(masked) % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      n_limbs == 1 ? launch<1>(packed, inv, flag, masked, out, batch, n_valid,
                               read_len, k, plan, shared_bytes, s)
                   : launch<2>(packed, inv, flag, masked, out, batch, n_valid,
                               read_len, k, plan, shared_bytes, s);
  return (int)err;
}

// --------------------------------------------------------------------------
// The pack: one pass over a batch of raw read codes that writes the 2-bit
// pack, the bit plane of the ambiguous bases, and a flag of the batch that
// says whether it holds any.
//
// Replaces no TPU kernel: the JAX package packs its reads on the host
// (genome_assembler_tpu/utils/dna.py pack_codes, pack_invalid_mask) after a
// host scan for ambiguous bases (has_ambiguous). The port uploads raw
// one-byte codes and packs them on the card; this kernel finds the
// ambiguous bases in that same pass, so that no host scan of the whole read
// array comes before the count, and the extraction kernel (above) reads
// the flag to take the invalid bits or leave them.
//
//   in : codes [n, L] uint8, rows contiguous (stride L): 0-3 a base, > 3 an
//        ambiguous base (N).
//   out: packed [n, ceil(L/4)] uint8, base j in byte j/4 at bit 2*(j%4), an
//        N as its low 2 bits (utils/dna.py pack_codes);
//        inv [n, ceil(L/8)] uint8, bit j%8 of byte j/8 set for an N
//        (pack_invalid_mask; zeros where the batch has none);
//        flag, one int32, zeroed on the stream before the launch and
//        non-zero after it iff any code is > 3; where `batches` is given,
//        the block that sets the flag first adds 1 to it (the batches that
//        held an N).
//
// What bounds it on the card: device-memory bytes. At 262,144 reads x 100
// bp: 26,214,400 B in, 6,553,600 + 3,407,872 B out, 36,175,872 B, 10.8 us
// at 3.35 TB/s; its arithmetic is a few dozen integer operations a group of
// 8 codes. What the design does about it:
//
//   * A group of 8 codes of a row is one byte of the invalid plane and two
//     of the packed row. Group g of the batch is byte g of the invalid
//     plane, and its codes are 8 contiguous bytes of the input, so
//     neighbouring threads on neighbouring groups read and write
//     neighbouring bytes: loads and stores coalesce whatever L is, and no
//     row is staged. A thread takes four groups, a block's width apart,
//     and issues all their loads before any arithmetic, so that enough
//     bytes are in flight to cover the memory's latency.
//   * The 8 codes come in as the aligned 32-bit words under them, joined by
//     funnel shifts; the pack is word arithmetic (the low 2 bits of 4 bytes
//     gathered by two shifts; the test for > 3 on 4 bytes at once by
//     __vcmpgtu4, its 4 bits gathered by one multiply).
//   * The flag costs a vote a block (__syncthreads_or) and an atomic only in
//     a block that saw an N.

namespace {

constexpr int kPackThreads = 256;
// groups of 8 codes a thread, kPackThreads apart
constexpr int kPackGroups = 4;

// The low 2 bits of the 4 bytes of w, byte i at bits 2i, 2i+1.
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  w &= 0x03030303u;
  w |= w >> 6;  // bytes 0 and 2 now hold two codes each
  return (w & 0x0fu) | ((w >> 12) & 0xf0u);
}

// Bit i set iff byte i of w is > 3.
__device__ __forceinline__ uint32_t bad4(uint32_t w) {
  const uint32_t hit = __vcmpgtu4(w, 0x03030303u) & 0x01010101u;
  // the products of the four bits land apart; bits 24-27 are bytes 0-3
  return (hit * 0x01020408u) >> 24;
}

__global__ void __launch_bounds__(kPackThreads) pack_reads_kernel(
    const uint8_t* __restrict__ codes, int64_t rows, int read_len,
    uint8_t* __restrict__ packed, uint8_t* __restrict__ inv,
    int* __restrict__ flag, unsigned long long* __restrict__ batches) {
  const int ib = (read_len + 7) >> 3;  // groups (invalid bytes) a row
  const int cb = (read_len + 3) >> 2;  // packed bytes a row
  const uint64_t groups = (uint64_t)rows * ib;
  const uintptr_t end = reinterpret_cast<uintptr_t>(codes) + rows * read_len;
  const uint32_t g0 = blockIdx.x * (kPackThreads * kPackGroups) + threadIdx.x;
  // every load of the thread's groups first, then the arithmetic
  uint32_t r[kPackGroups], x[kPackGroups][3];
  int j[kPackGroups], sh[kPackGroups];
#pragma unroll
  for (int i = 0; i < kPackGroups; ++i) {
    const uint32_t g = g0 + i * kPackThreads;
    r[i] = g / ib;
    j[i] = (int)(g - r[i] * ib);
    const uintptr_t at = reinterpret_cast<uintptr_t>(codes) +
                         (uint64_t)r[i] * read_len + 8 * j[i];
    sh[i] = 8 * (int)(at & 3);
    // the aligned words under the group's bytes; a word wholly past the
    // batch's last byte is not read
    const uint32_t* p = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      x[i][w] = g < groups && reinterpret_cast<uintptr_t>(p + w) < end
                    ? __ldg(p + w)
                    : 0u;
    }
  }
  bool any = false;
#pragma unroll
  for (int i = 0; i < kPackGroups; ++i) {
    const uint32_t g = g0 + i * kPackThreads;
    if (g >= groups) break;
    const int nv = min(8, read_len - 8 * j[i]);  // codes of the row in the group
    uint64_t v = ((uint64_t)__funnelshift_r(x[i][1], x[i][2], sh[i]) << 32) |
                 __funnelshift_r(x[i][0], x[i][1], sh[i]);
    if (nv < 8) v &= (1ull << (8 * nv)) - 1;  // past the row's end: 0
    const uint32_t lo = (uint32_t)v;
    const uint32_t hi = (uint32_t)(v >> 32);
    const uint32_t bits = bad4(lo) | (bad4(hi) << 4);
    inv[g] = (uint8_t)bits;
    const uint64_t po = (uint64_t)r[i] * cb + 2 * j[i];
    packed[po] = (uint8_t)pack4(lo);
    if (2 * j[i] + 1 < cb) packed[po + 1] = (uint8_t)pack4(hi);
    any |= bits != 0;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) {
    if (atomicExch(flag, 1) == 0 && batches != nullptr) atomicAdd(batches, 1ull);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Zeroes `flag` and launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported at once; a shape
// the kernel cannot take is cudaErrorInvalidValue. Rows must be contiguous
// in all three arrays; `batches` (an int64) may be null.
extern "C" int pack_reads_launch(const void* codes, long long rows,
                                 int read_len, void* packed, void* inv,
                                 void* flag, void* batches, void* stream) {
  const long long groups = rows * ((read_len + 7LL) / 8);
  if (rows < 0 || read_len < 1 || flag == nullptr || groups > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess || groups == 0) return (int)err;
  const long long blocks =
      (groups + kPackThreads * kPackGroups - 1) / (kPackThreads * kPackGroups);
  pack_reads_kernel<<<(unsigned)blocks, kPackThreads, 0, s>>>(
      (const uint8_t*)codes, rows, read_len, (uint8_t*)packed, (uint8_t*)inv,
      (int*)flag, (unsigned long long*)batches);
  return (int)cudaGetLastError();
}
