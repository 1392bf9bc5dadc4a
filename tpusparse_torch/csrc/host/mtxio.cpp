// Native host I/O core of tpusparse_torch: the port's own copy of csrc/mtxio.cpp.  It runs
// on the host CPU, never on the card; g++ builds it at first use (tpusparse_torch/native.py).
//
// Role parity with the reference's C host layer:
//   - Matrix Market reader        (reference src/io/io.cu:73-310)
//   - stencil .mtx writer         (reference src/io/io.cu:322-399)
//   - COO -> sorted-CSR builder   (reference src/spmv/spmv_cusparse_csr.cu:62-170)
//
// The reader/writer matter at scale: a 20k x 20k stencil matrix is ~2e9 ASCII lines
// (SURVEY.md section 7, "20k matrix materialization"); Python-level parsing is the actual
// bottleneck of the reference's real-world workflow.  This library memory-maps the file and
// parses with a hand-rolled integer/double scanner (no locale, no strtod round-trips for the
// common fixed-format case).
//
// Exposed as a plain C ABI consumed by ctypes (tpusparse_torch/native.py).  int64 indices
// throughout - the reference's `int nnz` overflows past ~21.5k grids (include/io.h:56).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) { ::close(fd); fd = -1; return false; }
        size = static_cast<size_t>(st.st_size);
        if (size == 0) { data = nullptr; return true; }
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) { ::close(fd); fd = -1; return false; }
        madvise(p, size, MADV_SEQUENTIAL);
        data = static_cast<const char*>(p);
        return true;
    }
    ~Mapped() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* skip_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
    p = skip_ws(p, end);
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    int64_t v = 0;
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    if (p == start) return nullptr;
    *out = neg ? -v : v;
    return p;
}

// strtod on a whitespace-delimited token starting at `start`.
inline const char* strtod_token(const char* start, const char* end, double* out) {
    char buf[80];
    size_t span = 0;
    const char* q = start;
    while (q < end && !(*q == ' ' || *q == '\t' || *q == '\n' || *q == '\r') &&
           span < sizeof(buf) - 1) {
        buf[span++] = *q++;
    }
    buf[span] = '\0';
    char* e = nullptr;
    *out = strtod(buf, &e);
    if (e == buf) return nullptr;
    return start + (e - buf);
}

// Fast double parser for the common short "[-]ddd.ddd" case.  The fast path is taken ONLY
// when it is provably bit-exact: <= 15 mantissa digits (so the integer fits 2^53 exactly)
// and a |10^k| <= 22 scale (exactly representable), one rounding total.  Everything else —
// exponents, long mantissas (e.g. %.17g output), leading-zero-heavy fractions — delegates
// to strtod, so correctness NEVER depends on the fast path.
inline const char* parse_f64(const char* p, const char* end, double* out) {
    p = skip_ws(p, end);
    const char* start = p;
    if (p < end && (*p == '-' || *p == '+')) ++p;
    uint64_t mant = 0;
    int digits = 0, frac_digits = 0;
    bool any = false, slow = false;
    while (p < end && *p >= '0' && *p <= '9') {
        if (digits < 15) { mant = mant * 10 + (*p - '0'); ++digits; } else { slow = true; }
        ++p; any = true;
    }
    if (p < end && *p == '.') {
        ++p;
        while (p < end && *p >= '0' && *p <= '9') {
            if (digits < 15) { mant = mant * 10 + (*p - '0'); ++digits; ++frac_digits; }
            else { slow = true; }
            ++p; any = true;
        }
    }
    if (!any) return nullptr;
    if (slow || (p < end && (*p == 'e' || *p == 'E')) || frac_digits > 15) {
        return strtod_token(start, end, out);
    }
    // exact powers of ten keep the fast path bit-exact (frac_digits <= 15 < 22 always here)
    static const double pow10[] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10,
                                   1e11, 1e12, 1e13, 1e14, 1e15};
    double v = static_cast<double>(mant) / pow10[frac_digits];
    *out = (*start == '-') ? -v : v;
    return p;
}

// Parses banner + comments; returns pointer to the first entry line, or nullptr on error.
const char* parse_header(const Mapped& m, int64_t* rows, int64_t* cols, int64_t* nnz,
                         int64_t* grid) {
    const char* p = m.data;
    const char* end = m.data + m.size;
    if (!p || m.size < 14 || strncmp(p, "%%MatrixMarket", 14) != 0) return nullptr;
    p = skip_line(p, end);
    *grid = 0;
    while (p < end && *p == '%') {
        const char* line_end = p;
        while (line_end < end && *line_end != '\n') ++line_end;
        static const char kTag[] = "STENCIL_GRID_SIZE";
        const char* f = std::search(p, line_end, kTag, kTag + sizeof(kTag) - 1);
        if (f != line_end) {
            int64_t g = 0;
            if (parse_i64(f + sizeof(kTag) - 1, line_end, &g)) *grid = g;
        }
        p = line_end < end ? line_end + 1 : end;
    }
    p = skip_ws(p, end);
    p = parse_i64(p, end, rows);
    if (!p) return nullptr;
    p = parse_i64(p, end, cols);
    if (!p) return nullptr;
    p = parse_i64(p, end, nnz);
    if (!p) return nullptr;
    return skip_line(p, end);
}

}  // namespace

extern "C" {

int mtx_read_header(const char* path, int64_t* rows, int64_t* cols, int64_t* nnz,
                    int64_t* grid) {
    Mapped m;
    if (!m.open(path)) return 1;
    return parse_header(m, rows, cols, nnz, grid) ? 0 : 2;
}

// Reads all entries (1-based on disk) into 0-based r/c/v arrays of capacity `cap`.
// Returns the number of entries read, or -1 on error.
int64_t mtx_read_entries(const char* path, int64_t cap, int64_t* r, int64_t* c, double* v) {
    Mapped m;
    if (!m.open(path)) return -1;
    int64_t rows, cols, nnz, grid;
    const char* p = parse_header(m, &rows, &cols, &nnz, &grid);
    if (!p) return -1;
    const char* end = m.data + m.size;
    int64_t k = 0;
    while (p < end && k < cap) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (*p == '%') { p = skip_line(p, end); continue; }
        int64_t ri, ci;
        double val;
        const char* q = parse_i64(p, end, &ri);
        if (!q) return -1;
        q = parse_i64(q, end, &ci);
        if (!q) return -1;
        q = parse_f64(q, end, &val);
        if (!q) return -1;
        r[k] = ri - 1;
        c[k] = ci - 1;
        v[k] = val;
        ++k;
        p = skip_line(q, end);
    }
    // Detect surplus data lines beyond the header's promised count so a corrupt file fails
    // identically on the native and numpy paths (return cap+1 → caller's count check trips).
    while (p < end) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (*p == '%') { p = skip_line(p, end); continue; }
        return k + 1;
    }
    return k;
}

// Writes the 5-point stencil matrix (diag + up to 4 neighbors, 1-based, entry order
// C,N,S,W,E per point like the reference io.cu:373-391).  Returns nnz, or -1 on error.
int64_t mtx_write_stencil5(const char* path, int64_t g, double diag, double offdiag) {
    if (g < 1) return -1;
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    setvbuf(f, nullptr, _IOFBF, 1 << 22);
    const int64_t n = g * g;
    const int64_t nnz = 5 * n - 4 * g;
    fprintf(f, "%%%%MatrixMarket matrix coordinate real general\n");
    fprintf(f, "%% STENCIL_GRID_SIZE %lld\n", static_cast<long long>(g));
    fprintf(f, "%lld %lld %lld\n", static_cast<long long>(n), static_cast<long long>(n),
            static_cast<long long>(nnz));
    char buf[160];
    for (int64_t i = 0; i < g; ++i) {
        for (int64_t j = 0; j < g; ++j) {
            const int64_t row = i * g + j + 1;  // 1-based
            int len = snprintf(buf, sizeof(buf), "%lld %lld %.17g\n",
                               static_cast<long long>(row), static_cast<long long>(row), diag);
            fwrite(buf, 1, static_cast<size_t>(len), f);
            if (i > 0) {
                len = snprintf(buf, sizeof(buf), "%lld %lld %.17g\n",
                               static_cast<long long>(row), static_cast<long long>(row - g),
                               offdiag);
                fwrite(buf, 1, static_cast<size_t>(len), f);
            }
            if (i < g - 1) {
                len = snprintf(buf, sizeof(buf), "%lld %lld %.17g\n",
                               static_cast<long long>(row), static_cast<long long>(row + g),
                               offdiag);
                fwrite(buf, 1, static_cast<size_t>(len), f);
            }
            if (j > 0) {
                len = snprintf(buf, sizeof(buf), "%lld %lld %.17g\n",
                               static_cast<long long>(row), static_cast<long long>(row - 1),
                               offdiag);
                fwrite(buf, 1, static_cast<size_t>(len), f);
            }
            if (j < g - 1) {
                len = snprintf(buf, sizeof(buf), "%lld %lld %.17g\n",
                               static_cast<long long>(row), static_cast<long long>(row + 1),
                               offdiag);
                fwrite(buf, 1, static_cast<size_t>(len), f);
            }
        }
    }
    const int rc = fclose(f);
    return rc == 0 ? nnz : -1;
}

// COO -> CSR with per-row column sort (reference build_csr_struct: count, prefix-sum,
// scatter, per-row sort — spmv_cusparse_csr.cu:62-170).  row_ptr has num_rows+1 slots.
int coo_to_csr_sorted(int64_t num_rows, int64_t nnz, const int64_t* r, const int64_t* c,
                      const double* v, int64_t* row_ptr, int64_t* col_idx, double* val) {
    std::vector<int64_t> count(static_cast<size_t>(num_rows), 0);
    for (int64_t k = 0; k < nnz; ++k) {
        if (r[k] < 0 || r[k] >= num_rows) return 1;
        ++count[static_cast<size_t>(r[k])];
    }
    row_ptr[0] = 0;
    for (int64_t i = 0; i < num_rows; ++i) row_ptr[i + 1] = row_ptr[i] + count[i];
    std::vector<int64_t> cursor(row_ptr, row_ptr + num_rows);
    for (int64_t k = 0; k < nnz; ++k) {
        const int64_t dst = cursor[static_cast<size_t>(r[k])]++;
        col_idx[dst] = c[k];
        val[dst] = v[k];
    }
    // per-row sort by column index (the [N,W,C,E,S] invariant the stencil extraction needs)
    std::vector<std::pair<int64_t, double>> tmp;
    for (int64_t i = 0; i < num_rows; ++i) {
        const int64_t lo = row_ptr[i], hi = row_ptr[i + 1];
        const int64_t len = hi - lo;
        if (len <= 1) continue;
        tmp.resize(static_cast<size_t>(len));
        for (int64_t k = 0; k < len; ++k)
            tmp[static_cast<size_t>(k)] = {col_idx[lo + k], val[lo + k]};
        std::sort(tmp.begin(), tmp.end(),
                  [](const auto& a, const auto& b) { return a.first < b.first; });
        for (int64_t k = 0; k < len; ++k) {
            col_idx[lo + k] = tmp[static_cast<size_t>(k)].first;
            val[lo + k] = tmp[static_cast<size_t>(k)].second;
        }
    }
    return 0;
}

}  // extern "C"
