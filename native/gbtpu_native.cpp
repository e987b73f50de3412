// gbtpu_native: native runtime components for graphblas_tpu.
//
// The reference implements its data loader and tuple builder in C
// (Demo/Source/read_matrix.c: fscanf triplet loop; Source/GB_builder.c:
// qsort + dup assembly).  These are the framework's host-side hot
// paths — graph ingest feeds the device, so parse + build throughput
// gates end-to-end time on large graphs.  This library provides:
//
//   * gbtpu_count_triplets / gbtpu_parse_triplets — mmap'd zero-copy
//     triplet parsing with a hand-rolled float scanner (~20x fscanf)
//   * gbtpu_sort_dedup — radix sort on (i,j) keys + in-order duplicate
//     fold with a selectable dup operator (the GB_builder analogue)
//   * gbtpu_coo_to_csr — counting-sort CSR assembly
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// mmap'd triplet parsing
// ---------------------------------------------------------------------------

namespace {

struct Mapped {
    const char *data = nullptr;
    size_t len = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char *path) {
    Mapped m;
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    void *p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    m.data = static_cast<const char *>(p);
    m.len = st.st_size;
    return m;
}

void unmap(Mapped &m) {
    if (m.data) munmap(const_cast<char *>(m.data), m.len);
    if (m.fd >= 0) close(m.fd);
}

inline const char *skip_ws(const char *p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

// Parse one whitespace-delimited token as a double.  Pure-integer tokens
// take a fast inline path (exact below 2^53); everything else — floats,
// exponents, nan/inf — is copied to a bounded buffer and handed to
// strtod so rounding matches libc (and numpy.loadtxt) to the ULP.
// Returns the position after the token, or nullptr if the token is not
// fully numeric (malformed input).
inline const char *parse_token(const char *p, const char *end, double *out) {
    p = skip_ws(p, end);
    if (p >= end || *p == '\n') return nullptr;
    const char *tok_end = p;
    while (tok_end < end && *tok_end != ' ' && *tok_end != '\t' &&
           *tok_end != '\r' && *tok_end != '\n') tok_end++;
    size_t len = tok_end - p;
    // fast path: optionally-signed pure-digit run (the index columns)
    {
        const char *q = p;
        bool neg = false;
        if (q < tok_end && (*q == '-' || *q == '+')) neg = (*q++ == '-');
        if (q < tok_end) {
            int64_t v = 0;
            const char *d = q;
            while (d < tok_end && *d >= '0' && *d <= '9' &&
                   v < (int64_t)1 << 52) v = v * 10 + (*d++ - '0');
            if (d == tok_end) {
                *out = neg ? -(double)v : (double)v;
                return tok_end;
            }
        }
    }
    if (len == 0 || len >= 64) return nullptr;
    char buf[64];
    memcpy(buf, p, len);
    buf[len] = '\0';
    char *ep = nullptr;
    double v = strtod(buf, &ep);
    if (ep != buf + len) return nullptr;  // trailing garbage in the token
    *out = v;
    return tok_end;
}

} // namespace

// Count data lines (for pre-allocation).  Returns -1 on error.
int64_t gbtpu_count_triplets(const char *path) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    int64_t lines = 0;
    const char *p = m.data, *end = m.data + m.len;
    while (p < end) {
        const char *q = skip_ws(p, end);
        if (q < end && *q != '\n' && *q != '%' && *q != '#') lines++;
        p = static_cast<const char *>(memchr(p, '\n', end - p));
        if (!p) break;
        p++;
    }
    unmap(m);
    return lines;
}

// Parse "i j [x]" lines into preallocated arrays.  Returns # parsed;
// -1 on I/O error; -2 on malformed input.  Policy (mirrored exactly by
// the Python fallback in io/read.py): a data line needs >= 2 numeric
// tokens; the 3rd token, when present, is the value (default 1.0);
// tokens past the 3rd are ignored; a malformed token among the first 3
// is an error, not a silent 1.0.
int64_t gbtpu_parse_triplets(const char *path, int64_t *I, int64_t *J,
                             double *X, int64_t cap) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char *p = m.data, *end = m.data + m.len;
    int64_t k = 0;
    while (p < end && k < cap) {
        const char *line_end =
            static_cast<const char *>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        const char *next_line = line_end;
        // '%' and '#' start a comment anywhere on the line (numpy
        // loadtxt's inline-comment behavior)
        for (const char *c = p; c < line_end; c++) {
            if (*c == '%' || *c == '#') { line_end = c; break; }
        }
        const char *q = skip_ws(p, line_end);
        if (q < line_end) {
            double i2, j2, x = 1.0;
            const char *r = parse_token(q, line_end, &i2);
            if (!r) { unmap(m); return -2; }
            r = parse_token(r, line_end, &j2);
            if (!r) { unmap(m); return -2; }
            const char *r3 = skip_ws(r, line_end);
            if (r3 < line_end) {  // a 3rd token exists: must be numeric
                if (!parse_token(r3, line_end, &x)) { unmap(m); return -2; }
            }
            I[k] = (int64_t)i2;
            J[k] = (int64_t)j2;
            X[k] = x;
            k++;
        }
        p = next_line + 1;
    }
    unmap(m);
    return k;
}

// ---------------------------------------------------------------------------
// sort + duplicate assembly (the GB_builder analogue)
// ---------------------------------------------------------------------------

namespace {

enum DupMode { DUP_PLUS = 0, DUP_FIRST = 1, DUP_LOR = 2, DUP_SECOND = 3,
               DUP_MIN = 4, DUP_MAX = 5, DUP_TIMES = 6 };

inline double dup_apply(int mode, double a, double b) {
    switch (mode) {
        case DUP_PLUS: return a + b;
        case DUP_FIRST: return a;
        case DUP_SECOND: return b;
        case DUP_LOR: return (a != 0 || b != 0) ? 1.0 : 0.0;
        case DUP_MIN: return a < b ? a : b;
        case DUP_MAX: return a > b ? a : b;
        case DUP_TIMES: return a * b;
    }
    return a;
}

// LSD radix sort of (key64 = i<<32|j approximated via pair) with a
// permutation payload.  Keys are (i, j) lexicographic; we sort the
// permutation by j then stable by i (two 64-bit radix passes, 8 bits
// per digit).
void radix_sort_pairs(const int64_t *Ikeys, const int64_t *Jkeys,
                      int64_t n, std::vector<int64_t> &perm) {
    perm.resize(n);
    for (int64_t k = 0; k < n; k++) perm[k] = k;
    std::vector<int64_t> tmp(n);
    auto pass = [&](const int64_t *keys, int shift) {
        size_t count[257] = {0};
        for (int64_t k = 0; k < n; k++)
            count[((keys[perm[k]] >> shift) & 0xff) + 1]++;
        for (int d = 0; d < 256; d++) count[d + 1] += count[d];
        for (int64_t k = 0; k < n; k++)
            tmp[count[(keys[perm[k]] >> shift) & 0xff]++] = perm[k];
        perm.swap(tmp);
    };
    int64_t jmax = 0, imax = 0;
    for (int64_t k = 0; k < n; k++) {
        if (Jkeys[k] > jmax) jmax = Jkeys[k];
        if (Ikeys[k] > imax) imax = Ikeys[k];
    }
    for (int s = 0; s < 64 && (jmax >> s); s += 8) pass(Jkeys, s);
    for (int s = 0; s < 64 && (imax >> s); s += 8) pass(Ikeys, s);
}

} // namespace

// In-place sort by (i,j) + fold duplicates in input order.  Returns the
// deduplicated count, or -1 on error.
int64_t gbtpu_sort_dedup(int64_t *I, int64_t *J, double *X, int64_t n,
                         int dup_mode) {
    if (n <= 0) return n;
    std::vector<int64_t> perm;
    radix_sort_pairs(I, J, n, perm);
    std::vector<int64_t> Is(n), Js(n);
    std::vector<double> Xs(n);
    for (int64_t k = 0; k < n; k++) {
        Is[k] = I[perm[k]];
        Js[k] = J[perm[k]];
        Xs[k] = X[perm[k]];
    }
    int64_t out = -1;
    for (int64_t k = 0; k < n; k++) {
        if (out >= 0 && Is[k] == I[out] && Js[k] == J[out]) {
            X[out] = dup_apply(dup_mode, X[out], Xs[k]);
        } else {
            out++;
            I[out] = Is[k];
            J[out] = Js[k];
            X[out] = Xs[k];
        }
    }
    return out + 1;
}

// COO (sorted by row) -> CSR indptr via counting.  indptr has nrows+1
// slots, caller-zeroed not required.
void gbtpu_coo_to_csr(const int64_t *I, int64_t nvals, int64_t nrows,
                      int64_t *indptr) {
    memset(indptr, 0, (nrows + 1) * sizeof(int64_t));
    for (int64_t k = 0; k < nvals; k++) indptr[I[k] + 1]++;
    for (int64_t r = 0; r < nrows; r++) indptr[r + 1] += indptr[r];
}

} // extern "C"

// ---------------------------------------------------------------------------
// OpenMP-parallel pair sort + pattern symmetrize/dedup (round 4).
//
// The reference's builder (GB_builder.c) and the Extras' prep codes
// (tri_prep.c) are where large-graph host time goes; these are their
// parallel equivalents: an LSD radix sort over linearized (i,j) keys
// with per-thread histograms, used by the CSR builder's host path and
// by the graph runners' symmetrize step.  Bit-exact with the numpy
// path: both produce ascending unique keys (radix LSD is stable).
// ---------------------------------------------------------------------------

#include <cstdint>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// parallel stable LSD radix sort of keys with an i64 payload.
// 11-bit digits; per-thread histograms merged into global offsets.
// pay == nullptr -> keys-only (dedup paths skip the payload traffic)
void radix_sort_kv(std::vector<uint64_t> &keys, std::vector<int64_t> *pay,
                   uint64_t maxkey) {
    const int64_t n = (int64_t)keys.size();
    if (n <= 1) return;
    constexpr int BITS = 11;
    constexpr int64_t R = 1 << BITS;
    int passes = 0;
    while (passes * BITS < 64 && (maxkey >> (passes * BITS)) != 0)
        passes++;
    if (passes == 0) passes = 1;
    std::vector<uint64_t> kbuf(n);
    std::vector<int64_t> pbuf(pay ? n : 0);
#ifdef _OPENMP
    const int nt = omp_get_max_threads();
#else
    const int nt = 1;
#endif
    std::vector<int64_t> hist((size_t)nt * R);
    for (int p = 0; p < passes; p++) {
        const int shift = p * BITS;
        std::fill(hist.begin(), hist.end(), 0);
#pragma omp parallel
        {
#ifdef _OPENMP
            const int t = omp_get_thread_num();
#else
            const int t = 0;
#endif
            int64_t *h = hist.data() + (size_t)t * R;
#pragma omp for schedule(static)
            for (int64_t k = 0; k < n; k++)
                h[(keys[k] >> shift) & (R - 1)]++;
        }
        // exclusive prefix over (digit, thread) in digit-major order
        int64_t run = 0;
        for (int64_t dgt = 0; dgt < R; dgt++)
            for (int t = 0; t < nt; t++) {
                int64_t c = hist[(size_t)t * R + dgt];
                hist[(size_t)t * R + dgt] = run;
                run += c;
            }
#pragma omp parallel
        {
#ifdef _OPENMP
            const int t = omp_get_thread_num();
#else
            const int t = 0;
#endif
            int64_t *h = hist.data() + (size_t)t * R;
#pragma omp for schedule(static)
            for (int64_t k = 0; k < n; k++) {
                int64_t dst = h[(keys[k] >> shift) & (R - 1)]++;
                kbuf[dst] = keys[k];
                if (pay) pbuf[dst] = (*pay)[k];
            }
        }
        keys.swap(kbuf);
        if (pay) pay->swap(pbuf);
    }
}

} // namespace

extern "C" {

// Sort (I, J) pairs by (i, j) ascending; writes the sorted pairs back
// and the applied permutation into perm (so callers reorder values).
// Requires nrows*ncols < 2^63.  Returns 0 ok / -1 on overflow.
int gbtpu_sort_pairs(int64_t *I, int64_t *J, int64_t n, int64_t nrows,
                     int64_t ncols, int64_t *perm) {
    if (n <= 0) return 0;
    if (ncols > 0 && nrows > ((int64_t)1 << 62) / ncols) return -1;
    std::vector<uint64_t> keys(n);
    std::vector<int64_t> pay(n);
    uint64_t mx = 0;
#pragma omp parallel for schedule(static) reduction(max : mx)
    for (int64_t k = 0; k < n; k++) {
        uint64_t key = (uint64_t)I[k] * (uint64_t)ncols + (uint64_t)J[k];
        keys[k] = key;
        pay[k] = k;
        if (key > mx) mx = key;
    }
    radix_sort_kv(keys, &pay, mx);
#pragma omp parallel for schedule(static)
    for (int64_t k = 0; k < n; k++) {
        I[k] = (int64_t)(keys[k] / (uint64_t)ncols);
        J[k] = (int64_t)(keys[k] % (uint64_t)ncols);
        perm[k] = pay[k];
    }
    return 0;
}

// Symmetrize an edge list: emit sorted unique {(i,j)} U {(j,i)} with
// self-loops removed.  I/J are caller buffers of capacity 2*ne holding
// ne input pairs; returns the output count (pairs written back), or -1
// on overflow.  Exactly np.unique(concat([i*n+j, j*n+i])) minus the
// diagonal, in the same ascending order.
int64_t gbtpu_sym_dedup_pattern(int64_t *I, int64_t *J, int64_t ne,
                                int64_t n) {
    if (ne <= 0) return 0;
    if (n > 0 && n > ((int64_t)1 << 62) / n) return -1;
    // parallel fill; self-loops become the max sentinel and sort last
    constexpr uint64_t SENT = ~(uint64_t)0;
    std::vector<uint64_t> keys(2 * ne);
    uint64_t mx = 0;
#pragma omp parallel for schedule(static) reduction(max : mx)
    for (int64_t k = 0; k < ne; k++) {
        if (I[k] == J[k]) {
            keys[2 * k] = SENT;
            keys[2 * k + 1] = SENT;
            continue;
        }
        uint64_t a = (uint64_t)I[k] * (uint64_t)n + (uint64_t)J[k];
        uint64_t b = (uint64_t)J[k] * (uint64_t)n + (uint64_t)I[k];
        keys[2 * k] = a;
        keys[2 * k + 1] = b;
        uint64_t m = a > b ? a : b;
        if (m > mx) mx = m;
    }
    radix_sort_kv(keys, nullptr, mx == 0 ? 1 : mx);
    // passes cover only the real-key bits, so a sentinel can TIE with
    // a real key whose covered digits are all ones and land anywhere
    // among its equals — skip sentinels and dedup against the last
    // EMITTED key, never positional neighbours
    int64_t out = 0;
    uint64_t last = SENT;   // real keys < n*n <= 2^62 < SENT
    for (size_t k = 0; k < keys.size(); k++) {
        if (keys[k] == SENT) continue;
        if (out && keys[k] == last) continue;
        last = keys[k];
        I[out] = (int64_t)(keys[k] / (uint64_t)n);
        J[out] = (int64_t)(keys[k] % (uint64_t)n);
        out++;
    }
    return out;
}

} // extern "C"
