// Host-side XOR-metric engine.
//
// Native implementation of the reference's scalar id kernels and the
// sorted-map outward walk (reference: include/opendht/infohash.h:149-210
// xorCmp/commonBits/cmp; src/node_cache.cpp:41-74 getCachedNodes).  This
// is the host fallback/baseline path of the TPU framework: per-packet
// table ops on small live tables run here, batched/simulated lookups run
// on the device kernels (opendht_tpu/ops/*).
//
// C ABI only (consumed via ctypes).  IDs are 20-byte big-endian rows in
// a contiguous [N, 20] uint8 buffer.
//
// Build: g++ -O3 -shared -fPIC -o libdht_native.so xor_engine.cpp udp_engine.cpp

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {
constexpr int HASH_LEN = 20;

inline int cmp_id(const uint8_t* a, const uint8_t* b) {
    return std::memcmp(a, b, HASH_LEN);
}

// which of a,b is XOR-closer to self: <0 a closer, >0 b closer, 0 equal
// (infohash.h:179-194)
inline int xor_cmp(const uint8_t* self, const uint8_t* a, const uint8_t* b) {
    for (int i = 0; i < HASH_LEN; ++i) {
        uint8_t da = a[i] ^ self[i];
        uint8_t db = b[i] ^ self[i];
        if (da != db) return da < db ? -1 : 1;
    }
    return 0;
}

inline int common_bits(const uint8_t* a, const uint8_t* b) {
    for (int i = 0; i < HASH_LEN; ++i) {
        uint8_t x = a[i] ^ b[i];
        if (x) {
            int j = 0;
            while (!(x & 0x80)) { x <<= 1; ++j; }
            return i * 8 + j;
        }
    }
    return HASH_LEN * 8;
}
} // namespace

extern "C" {

int dht_xor_cmp(const uint8_t* self, const uint8_t* a, const uint8_t* b) {
    return xor_cmp(self, a, b);
}

int dht_common_bits(const uint8_t* a, const uint8_t* b) {
    return common_bits(a, b);
}

int dht_cmp(const uint8_t* a, const uint8_t* b) {
    int c = cmp_id(a, b);
    return c < 0 ? -1 : (c > 0 ? 1 : 0);
}

// Lexicographically sort an [N,20] id matrix in place, carrying a
// permutation of original row indices.  perm must hold N int32.
void dht_sort_ids(uint8_t* ids, int32_t* perm, int64_t n) {
    for (int64_t i = 0; i < n; ++i) perm[i] = (int32_t)i;
    // sort the permutation, then apply (avoids moving rows during compare)
    std::sort(perm, perm + n, [ids](int32_t a, int32_t b) {
        return cmp_id(ids + (int64_t)a * HASH_LEN,
                      ids + (int64_t)b * HASH_LEN) < 0;
    });
    // apply permutation out-of-place
    uint8_t* tmp = new uint8_t[(size_t)n * HASH_LEN];
    for (int64_t i = 0; i < n; ++i)
        std::memcpy(tmp + i * HASH_LEN,
                    ids + (int64_t)perm[i] * HASH_LEN, HASH_LEN);
    std::memcpy(ids, tmp, (size_t)n * HASH_LEN);
    delete[] tmp;
}

void dht_scan_closest(const uint8_t* ids, int64_t n,
                      const uint8_t* queries, int64_t nq,
                      int32_t k, int32_t* out);

// First index i in [0,n) with sorted_ids[i] >= q (lower bound).
int64_t dht_lower_bound(const uint8_t* sorted_ids, int64_t n,
                        const uint8_t* q) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (cmp_id(sorted_ids + mid * HASH_LEN, q) < 0) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// The reference's NodeCache::getCachedNodes walk (node_cache.cpp:41-74)
// made exact: the reference walks outward from the insertion point
// taking the XOR-closer frontier side directly — a heuristic, since XOR
// distance is not monotone in lexicographic offset.  Here the walk only
// *collects* a `window`-wide candidate set (which, by the common-prefix
// containment property, holds the true top-k whenever window is large
// enough — same argument as the device kernel's certificate,
// ops/sorted_table.py), and an exact insertion-select over the
// candidates picks the k closest.  window < k is clamped to k.
// Writes k int32 sorted-table indices per query into out (row-major
// [nq,k]); -1 padding when fewer than k rows exist.
void dht_sorted_closest(const uint8_t* sorted_ids, int64_t n,
                        const uint8_t* queries, int64_t nq,
                        int32_t k, int32_t window, int32_t* out) {
    if (window < k) window = k;
    std::vector<int64_t> cand((size_t)window);
    for (int64_t qi = 0; qi < nq; ++qi) {
        const uint8_t* q = queries + qi * HASH_LEN;
        int32_t* row = out + qi * k;
        int64_t pos = dht_lower_bound(sorted_ids, n, q);
        int64_t lo = pos - 1, hi = pos;
        int32_t ncand = 0;
        while (ncand < window && (lo >= 0 || hi < n)) {
            bool take_lo;
            if (lo < 0) take_lo = false;
            else if (hi >= n) take_lo = true;
            else take_lo = xor_cmp(q, sorted_ids + lo * HASH_LEN,
                                   sorted_ids + hi * HASH_LEN) <= 0;
            cand[ncand++] = take_lo ? lo-- : hi++;
        }
        // exact k-closest among the candidates (insertion select)
        int32_t got = 0;
        for (int32_t c = 0; c < ncand; ++c) {
            const uint8_t* cid = sorted_ids + cand[c] * HASH_LEN;
            int32_t p = got;
            while (p > 0 && xor_cmp(q, cid, sorted_ids +
                                    (int64_t)row[p - 1] * HASH_LEN) < 0)
                --p;
            if (p < k) {
                int32_t end = got < k ? got : k - 1;
                for (int32_t m = end; m > p; --m) row[m] = row[m - 1];
                row[p] = (int32_t)cand[c];
                if (got < k) ++got;
            }
        }
        for (int32_t g = got; g < k; ++g) row[g] = -1;

        // exactness certificate (same argument as the device kernel,
        // ops/sorted_table.py:134-157): excluded nodes sit beyond the
        // window's edges; the kth result beats them all iff it shares a
        // strictly longer prefix with q than the nearest excluded
        // neighbor on each unexhausted side.  On failure, fall back to
        // the exact full scan for this query.
        bool certified = true;
        if (got == k) {
            int cp_k = common_bits(q, sorted_ids +
                                   (int64_t)row[k - 1] * HASH_LEN);
            if (lo >= 0 &&
                cp_k <= common_bits(q, sorted_ids + lo * HASH_LEN))
                certified = false;
            if (hi < n &&
                cp_k <= common_bits(q, sorted_ids + hi * HASH_LEN))
                certified = false;
        } else if (lo >= 0 || hi < n) {
            certified = false;   // fewer than k found but rows excluded
        }
        if (!certified)
            dht_scan_closest(sorted_ids, n, q, 1, k, row);
    }
}

// Exact full-scan oracle: k XOR-closest rows per query by selection scan
// (O(n·k) per query; used for parity tests and small tables).
void dht_scan_closest(const uint8_t* ids, int64_t n,
                      const uint8_t* queries, int64_t nq,
                      int32_t k, int32_t* out) {
    for (int64_t qi = 0; qi < nq; ++qi) {
        const uint8_t* q = queries + qi * HASH_LEN;
        int32_t* row = out + qi * k;
        int32_t got = 0;
        for (int64_t i = 0; i < n; ++i) {
            const uint8_t* cand = ids + i * HASH_LEN;
            // insertion position among current results
            int32_t p = got;
            while (p > 0 &&
                   xor_cmp(q, cand, ids + (int64_t)row[p - 1] * HASH_LEN) < 0)
                --p;
            if (p < k) {
                int32_t end = got < k ? got : k - 1;
                for (int32_t m = end; m > p; --m) row[m] = row[m - 1];
                row[p] = (int32_t)i;
                if (got < k) ++got;
            }
        }
        for (; got < k; ++got) row[got] = -1;
    }
}

} // extern "C"
