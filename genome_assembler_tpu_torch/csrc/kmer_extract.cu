// Canonical k-mer extraction for Hopper (sm_90a): every window built in a
// fixed number of steps from the packed row's own bits, one contiguous
// stream of 16-byte stores a block.
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

template <int NL>
__global__ void __launch_bounds__(kThreads) extract_canonical_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ inv,
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
  const bool has_inv = inv != nullptr;
  const int code_bytes = (read_len + 3) >> 2;  // a packed row
  const int inv_bytes = (read_len + 7) >> 3;

  // bit of the staged streams at which the block's first row starts
  const int code_bit0 =
      8 * stage_span(scodes, packed + r0 * code_bytes, rows * code_bytes);
  const int inv_bit0 =
      has_inv ? 8 * stage_span(sinv, inv + r0 * inv_bytes, rows * inv_bytes)
              : 0;
  __syncthreads();

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
        const bool live = i == 0 || j + 1 < n;
        const bool bad =
            !live || r0 + r >= n_valid ||
            (has_inv &&
             window_bad(sinv, inv_bit0 + 8 * r * inv_bytes + w, k));
        v[i] = bad ? kSentinel
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
      const bool bad =
          r0 + r >= n_valid ||
          (has_inv && window_bad(sinv, inv_bit0 + 8 * r * inv_bytes + w, k));
      gdst[j] = bad ? make_longlong2(kSentinel, kSentinel)
                    : key_two_limbs(
                          scodes, code_bit0 + 8 * r * code_bytes + 2 * w, k);
    }
  }
}

template <int NL>
cudaError_t launch(const void* packed, const void* inv, void* out,
                   long long batch, long long n_valid, int read_len, int k,
                   Plan plan, long long shared_bytes, cudaStream_t stream) {
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
      (const uint8_t*)packed, (const uint8_t*)inv, (long long*)out, batch, n_valid, read_len, k, plan);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported at once; a plan or a pointer the kernel cannot
// take is cudaErrorInvalidValue. Rows must be contiguous (stride = row
// bytes). inv may be null (no invalid bases).
extern "C" int kmer_extract_launch(
    const void* packed, long long packed_stride, const void* inv,
    long long inv_stride, void* out, long long batch, long long n_valid,
    int read_len, int k, int n_limbs, int reads_per_block, int code_words,
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
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      n_limbs == 1 ? launch<1>(packed, inv, out, batch, n_valid, read_len, k,
                               plan, shared_bytes, s)
                   : launch<2>(packed, inv, out, batch, n_valid, read_len, k,
                               plan, shared_bytes, s);
  return (int)err;
}
