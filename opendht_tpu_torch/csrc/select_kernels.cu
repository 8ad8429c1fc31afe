// Exact lexicographic XOR top-k selects for Hopper (sm_90a).
//
// Two kernels, each the hand port of one Pallas TPU kernel of the JAX
// package, behind a plain C interface loaded with ctypes
// (opendht_tpu_torch/ops/_build.py):
//
//   window_select_launch   <- opendht_tpu/ops/pallas_window_topk.py
//                             window_select (_kernel)
//   lex_topk_select_launch <- opendht_tpu/ops/pallas_select.py
//                             lex_topk_select (_select_kernel)
//
// Both compute k rounds of exact min-extraction in the order
// (d0, d1, d2, d3, d4, position): the first-differing-limb rule of
// InfoHash::xorCmp, then the smallest position among full 160-bit ties;
// the winner leaves the live set.
//
// Design: one warp per query and one select core shared by both kernels
// (select_round below).  Each thread holds its candidates (positions
// lane + 32*i) in registers as 64-bit keys, limb-0 distance above the
// position, and sorts them once with a sorting network, so its head is
// its best on limb 0.  A round is one __reduce_min_sync over the heads'
// limb 0 and two ballots taken together: the lanes whose head holds the
// minimum, and those whose next candidate holds it too.  With one such
// lane and no second candidate (every round on uniform ids), that lane
// wins, records the position and pops its head: a shift of NPT
// registers.  Only when candidates share limb 0 (about 2^-32 per pair on
// uniform ids) does the round read limbs 1..4 of the tied candidates from
// memory and narrow through them and then the position.  The other
// limbs are read once more at the end, for the k winners only.  "No live
// candidate" is a count, not a distance, so a valid candidate at an
// all-ones distance still beats an exhausted lane.
//
// What bounds them: device memory for lex_topk_select; for
// window_select at k=16, instruction issue in the rounds (one reduction,
// two ballots and a register shift each, PERF.md).  window_select
// reads each query's expanded row where it lies (row_index), so the
// caller gathers no [Q, 970] rows into a temporary, and of that row it
// reads the limb-0 plane and the winners' limbs;
// lex_topk_select reads each query's W*5 contiguous words with coalesced
// loads through a small shared-memory stage.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() of its launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 5;
constexpr int kErow = 194;                // lanes per limb plane
constexpr int kWin = 192;                 // candidate window lanes
constexpr int kWinPerThread = kWin / 32;  // 6
constexpr int kOutLanes = 128;            // packed output row
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;

// The select core.  Each thread holds NPT candidates as 64-bit keys
// (limb-0 distance << 32 | position), sorted ascending once; slots
// [0, n) are live, the rest all-ones.  A thread's head (slot 0) is its
// best candidate on limb 0, and candidates that share its limb 0 follow
// it.
template <int NPT>
struct Cands {
  uint64_t key[NPT];
  int n;
};

__device__ __forceinline__ void compare_exchange(uint64_t& a, uint64_t& b) {
  const uint64_t lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// Sorting network on registers: bitonic for a power of two, odd-even
// transposition otherwise (NPT = 6).
template <int NPT>
__device__ __forceinline__ void sort_keys(uint64_t (&a)[NPT]) {
  if constexpr ((NPT & (NPT - 1)) == 0) {
#pragma unroll
    for (int size = 2; size <= NPT; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const int j = i ^ stride;
          if (j > i) {
            if ((i & size) == 0) compare_exchange(a[i], a[j]);
            else compare_exchange(a[j], a[i]);
          }
        }
  } else {
#pragma unroll
    for (int r = 0; r < NPT; ++r)
#pragma unroll
      for (int i = r & 1; i + 1 < NPT; i += 2) compare_exchange(a[i], a[i + 1]);
  }
}

template <int NPT>
__device__ __forceinline__ void pop_head(Cands<NPT>& c) {
#pragma unroll
  for (int i = 0; i + 1 < NPT; ++i) c.key[i] = c.key[i + 1];
  c.key[NPT - 1] = ~0ull;
  --c.n;
}

__device__ __forceinline__ uint32_t limb0(uint64_t key) {
  return static_cast<uint32_t>(key >> 32);
}

__device__ __forceinline__ int position(uint64_t key) {
  return static_cast<int>(static_cast<uint32_t>(key));
}

// One round: the lane whose live candidate is the warp's
// (d0, d1, d2, d3, d4, position) minimum, with that candidate moved to
// its slot 0, or -1 when no lane has a live candidate.  limb(p, l) is
// limb l (1..4) of the raw distance at position p, read only when
// candidates tie on limb 0.
template <int NPT, class Limb>
__device__ __forceinline__ int select_round(Cands<NPT>& c, const Limb& limb) {
  const int lane = threadIdx.x & 31;
  const bool has = c.n > 0;
  const uint32_t h0 = has ? limb0(c.key[0]) : kNone;
  const uint32_t m0 = __reduce_min_sync(kFull, h0);
  bool in = has && h0 == m0;
  bool dup = false;  // a second live candidate of this lane shares m0
  if constexpr (NPT > 1) dup = in && c.n > 1 && limb0(c.key[1]) == m0;
  unsigned tied = __ballot_sync(kFull, in);
  const unsigned dups = __ballot_sync(kFull, dup);
  if (tied == 0u) return -1;
  if (__popc(tied) == 1 && dups == 0u) return __ffs(tied) - 1;

  // Rare: several candidates share limb 0.  Each tied lane finds its
  // exact best among its own, then the lanes narrow through limbs 1..4
  // and the position.
  uint32_t b[kLimbs - 1] = {kNone, kNone, kNone, kNone};
  int bs = -1, bp = INT_MAX;
  if (in) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      if (i < c.n && limb0(c.key[i]) == m0) {
        const int p = position(c.key[i]);
        uint32_t v[kLimbs - 1];
#pragma unroll
        for (int l = 0; l < kLimbs - 1; ++l) v[l] = limb(p, l + 1);
        bool lt = p < bp;
#pragma unroll
        for (int l = kLimbs - 2; l >= 0; --l)
          lt = v[l] < b[l] || (v[l] == b[l] && lt);
        if (bs < 0 || lt) {
#pragma unroll
          for (int l = 0; l < kLimbs - 1; ++l) b[l] = v[l];
          bs = i;
          bp = p;
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kLimbs - 1; ++l) {
    if (__popc(tied) == 1) break;
    const uint32_t m = __reduce_min_sync(kFull, in ? b[l] : kNone);
    in = in && b[l] == m;
    tied = __ballot_sync(kFull, in);
  }
  const int w = __popc(tied) == 1
                    ? __ffs(tied) - 1
                    : __reduce_min_sync(kFull, in ? bp : INT_MAX) & 31;
  if (lane == w) {
#pragma unroll
    for (int i = 1; i < NPT; ++i)
      if (i == bs) {
        const uint64_t t = c.key[0];
        c.key[0] = c.key[i];
        c.key[i] = t;
      }
  }
  return w;
}

// expanded  [NB, 5*194] id limbs, limb-planar (lane 0 / 193 = certificate
//           neighbours, lanes 1..192 = the window)
// row_index [Q] row of expanded that query q reads; nullptr = row q
// q8        [Q, 8]     query limbs 0..4 (same bit domain as expanded)
// bounds    [Q, 8]     col 0 = number of valid window lanes
// out       [Q, 128]   cols [l*k,(l+1)*k) = winners' distance limb l in the
//           sign-flipped domain (u ^ 0x80000000), cols [5k,6k) = winners'
//           local lane (192 once the valid lanes are exhausted), rest 0
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
window_select_kernel(const uint32_t* __restrict__ expanded,
                     const int32_t* __restrict__ row_index,
                     const uint32_t* __restrict__ q8,
                     const int32_t* __restrict__ bounds,
                     uint32_t* __restrict__ out, int Q, int k) {
  __shared__ int stage[kWarpsPerBlock][32];  // winners' lanes, k <= 21
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + warp;
  if (q >= Q) return;  // the whole warp leaves together

  const size_t r = row_index ? static_cast<size_t>(row_index[q])
                             : static_cast<size_t>(q);
  const uint32_t* row = expanded + r * (kLimbs * kErow) + 1;  // window lane 0
  const uint32_t* qq = q8 + static_cast<size_t>(q) * 8;
  const int bound = bounds[static_cast<size_t>(q) * 8];
  const uint32_t q0 = qq[0];
  Cands<kWinPerThread> c;
  c.n = 0;
#pragma unroll
  for (int i = 0; i < kWinPerThread; ++i) {
    const int L = lane + 32 * i;
    const bool valid = L < bound;
    c.key[i] = valid ? (static_cast<uint64_t>(row[L] ^ q0) << 32 | L) : ~0ull;
    c.n += valid;
  }
  sort_keys(c.key);
  const auto limb = [&](int p, int l) { return row[l * kErow + p] ^ qq[l]; };

  int* st = stage[warp];
  for (int rr = 0; rr < k; ++rr) {
    const int w = select_round(c, limb);
    if (w < 0) {  // exhausted: lane 192 for every round left
      for (int s = rr + lane; s < k; s += 32) st[s] = kWin;
      break;
    }
    if (lane == w) {
      st[rr] = position(c.key[0]);
      pop_head(c);
    }
  }
  __syncwarp();
  // the winners' limbs, read again from the row (cached), one per lane
  uint32_t* o = out + static_cast<size_t>(q) * kOutLanes;
  for (int col = lane; col < kOutLanes; col += 32) {
    uint32_t v = 0u;
    if (col < (kLimbs + 1) * k) {
      const int l = col / k, L = st[col % k];
      if (l == kLimbs) v = static_cast<uint32_t>(L);
      else v = (L < kWin ? row[l * kErow + L] ^ qq[l] : kNone) ^ 0x80000000u;
    }
    o[col] = v;
  }
}

// dist [Q, W, 5] distance limbs in the sign-flipped int32 domain
// inv  [Q, W]    nonzero = never selected
// out  [Q, k]    window positions, -1 once the valid rows run out
template <int NPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lex_select_kernel(const int32_t* __restrict__ dist,
                  const int32_t* __restrict__ inv,
                  int32_t* __restrict__ out, int Q, int W, int k) {
  // one 32-position chunk (160 words) per warp at a time
  __shared__ uint32_t stage[kWarpsPerBlock][32 * kLimbs];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + warp;
  if (q >= Q) return;

  const auto* dq = reinterpret_cast<const uint32_t*>(dist) +
                   static_cast<size_t>(q) * W * kLimbs;
  const int32_t* iq = inv + static_cast<size_t>(q) * W;
  uint32_t* st = stage[warp];
  Cands<NPT> c;
  c.n = 0;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    // coalesced: lanes read consecutive words of the chunk
#pragma unroll
    for (int t = 0; t < kLimbs; ++t) {
      const int wd = 32 * kLimbs * i + 32 * t + lane;
      st[32 * t + lane] = wd < W * kLimbs ? dq[wd] : kNone;
    }
    __syncwarp();
    const int p = lane + 32 * i;
    const bool valid = p < W && iq[p] == 0;
    // key -> uint32 compare domain (signed order == unsigned order of x^2^31)
    const uint32_t d0 = st[lane * kLimbs] ^ 0x80000000u;
    c.key[i] = valid ? (static_cast<uint64_t>(d0) << 32 | p) : ~0ull;
    c.n += valid;
    __syncwarp();
  }
  sort_keys(c.key);
  const auto limb = [&](int p, int l) {
    return dq[p * kLimbs + l] ^ 0x80000000u;
  };

  int32_t* oq = out + static_cast<size_t>(q) * k;
  for (int kk = 0; kk < k; ++kk) {
    const int w = select_round(c, limb);
    if (w < 0) {  // exhausted: -1 for every round left
      for (int s = kk + lane; s < k; s += 32) oq[s] = -1;
      break;
    }
    if (lane == w) {
      oq[kk] = position(c.key[0]);
      pop_head(c);
    }
  }
}

int blocks_for(int Q) { return (Q + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" int window_select_launch(const void* expanded,
                                    const void* row_index, const void* q8,
                                    const void* bounds, void* out, int Q,
                                    int k, void* stream) {
  if (Q <= 0) return 0;
  window_select_kernel<<<blocks_for(Q), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(expanded),
      static_cast<const int32_t*>(row_index),
      static_cast<const uint32_t*>(q8), static_cast<const int32_t*>(bounds),
      static_cast<uint32_t*>(out), Q, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lex_topk_select_launch(const void* dist, const void* inv,
                                      void* out, int Q, int W, int k,
                                      void* stream) {
  if (Q <= 0) return 0;
  const auto* d = static_cast<const int32_t*>(dist);
  const auto* iv = static_cast<const int32_t*>(inv);
  auto* o = static_cast<int32_t*>(out);
  const dim3 grid(blocks_for(Q)), block(kWarpsPerBlock * 32);
  auto s = static_cast<cudaStream_t>(stream);
  if (W <= 32) lex_select_kernel<1><<<grid, block, 0, s>>>(d, iv, o, Q, W, k);
  else if (W <= 64) lex_select_kernel<2><<<grid, block, 0, s>>>(d, iv, o, Q, W, k);
  else if (W <= 128) lex_select_kernel<4><<<grid, block, 0, s>>>(d, iv, o, Q, W, k);
  else if (W <= 256) lex_select_kernel<8><<<grid, block, 0, s>>>(d, iv, o, Q, W, k);
  else if (W <= 512) lex_select_kernel<16><<<grid, block, 0, s>>>(d, iv, o, Q, W, k);
  else if (W <= 1024) lex_select_kernel<32><<<grid, block, 0, s>>>(d, iv, o, Q, W, k);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
