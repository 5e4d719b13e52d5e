// Native read ingestion: mmap + 2-bit encode (reference C1 at scale).
//
// The reference parses reads in Python (SURVEY.md §2.1 C1); at CFG-3 scale
// (~1 GB of reads) Python line parsing costs tens of seconds, so the TPU
// framework ships a C++ loader: mmap the file, scan line/FASTA/FASTQ
// structure, and encode ACGT -> 2-bit codes straight into a caller-provided
// [B, L] uint8 buffer ready for jax.device_put. Ambiguous bases (N etc.)
// encode to 4 — the pipeline masks the k-mer windows they touch instead of
// aborting (VERDICT r1 item 7). FASTQ quality lines are skipped. Exposed
// via ctypes (utils/io_native.py); pure-Python fallback remains in
// cli.read_sequences.
//
// Build: make -C genome_assembler_tpu_torch/native  (produces libga_io.so)

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint8_t kInvalidBase = 4;  // mirrors utils.dna.INVALID_CODE

// 255 = other (ambiguous base), 254 = newline, 253 = '>', 252 = '@',
// 251 = '\r' (skipped everywhere for CRLF tolerance)
struct Lut {
    uint8_t v[256];
    constexpr Lut() : v() {
        for (int i = 0; i < 256; ++i) v[i] = 255;
        v['A'] = v['a'] = 0;
        v['C'] = v['c'] = 1;
        v['G'] = v['g'] = 2;
        v['T'] = v['t'] = 3;
        v['\n'] = 254;
        v['>'] = 253;
        v['@'] = 252;
        v['\r'] = 251;
    }
};
constexpr Lut kLut;

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
    Mapped m;
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    m.data = static_cast<const char*>(p);
    m.size = st.st_size;
    return m;
}

void unmap(Mapped& m) {
    if (m.data) munmap(const_cast<char*>(m.data), m.size);
    if (m.fd >= 0) close(m.fd);
}

// Shared walk over the file structure; Sink receives (base_code, row, col)
// for every sequence base (base_code in 0..3 or kInvalidBase).
// Returns the number of sequences, sets *uniform_len (-1 if ragged).
template <typename Sink>
int64_t walk(const char* data, size_t size, int64_t* uniform_len,
             int32_t* has_invalid, Sink&& sink) {
    const char* p = data;
    const char* end = data + size;
    bool fasta = *p == '>';
    bool fastq = *p == '@';
    int64_t count = 0, uniform = -2;  // -2 unset, -1 ragged
    int64_t cur = 0;
    bool in_header = false, invalid = false, in_seq = false;
    int fq_phase = 0;  // FASTQ: 0 header, 1 sequence, 2 plus, 3 quality

    auto close_seq = [&]() {
        if (!in_seq) return;
        if (uniform == -2) uniform = cur;
        else if (uniform != cur) uniform = -1;
        ++count;
        cur = 0;
        in_seq = false;
    };

    for (; p < end; ++p) {
        uint8_t c = kLut.v[static_cast<uint8_t>(*p)];
        if (c == 251) continue;  // '\r'
        if (fastq) {
            if (c == 254) {
                if (fq_phase == 1) close_seq();
                fq_phase = (fq_phase + 1) % 4;
            } else if (fq_phase == 1) {
                uint8_t code = c <= 3 ? c : kInvalidBase;
                if (code == kInvalidBase) invalid = true;
                sink(code, count, cur);
                ++cur;
                in_seq = true;
            }
            continue;
        }
        if (in_header) {
            if (c == 254) in_header = false;
            continue;
        }
        if (c == 253 && fasta) {  // next record
            close_seq();
            in_header = true;
        } else if (c == 254) {
            if (!fasta) close_seq();  // line mode: newline ends a read
        } else {
            uint8_t code = c <= 3 ? c : kInvalidBase;
            if (code == kInvalidBase) invalid = true;
            sink(code, count, cur);
            ++cur;
            in_seq = true;
        }
    }
    if (!fastq || fq_phase == 1) close_seq();
    *uniform_len = uniform == -2 ? 0 : uniform;
    if (has_invalid) *has_invalid = invalid ? 1 : 0;
    return count;
}

}  // namespace

extern "C" {

// Pass 1: scan structure. Returns 0 on success.
//   *num_reads   <- number of sequences
//   *read_len    <- uniform sequence length, or -1 if ragged
//   *has_invalid <- 1 if any non-ACGT base occurs in sequence data
int ga_scan_reads(const char* path, int64_t* num_reads, int64_t* read_len,
                  int32_t* has_invalid) {
    Mapped m = map_file(path);
    if (!m.ok()) return 1;
    *num_reads = walk(m.data, m.size, read_len, has_invalid,
                      [](uint8_t, int64_t, int64_t) {});
    unmap(m);
    return 0;
}

// Pass 2: encode into out[num_reads * read_len] (uniform reads only).
// Returns 0 on success, 2 if layout changed since scan.
int ga_encode_reads(const char* path, uint8_t* out, int64_t num_reads,
                    int64_t read_len) {
    Mapped m = map_file(path);
    if (!m.ok()) return 1;
    bool overrun = false;
    int64_t uniform = 0;
    int64_t count = walk(
        m.data, m.size, &uniform, nullptr,
        [&](uint8_t code, int64_t row, int64_t col) {
            if (row >= num_reads || col >= read_len) {
                overrun = true;
                return;
            }
            out[row * read_len + col] = code;
        });
    unmap(m);
    return (overrun || count != num_reads || uniform != read_len) ? 2 : 0;
}

// Decode 2-bit codes back to ACGTN ASCII (contig emission helper).
void ga_decode_seq(const uint8_t* codes, int64_t n, char* out) {
    static const char kBases[5] = {'A', 'C', 'G', 'T', 'N'};
    for (int64_t i = 0; i < n; ++i)
        out[i] = kBases[codes[i] > 4 ? 4 : codes[i]];
}

}  // extern "C"
