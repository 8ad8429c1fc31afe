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
// Both compute k rounds of progressive-mask min-extraction: per round,
// the minimum of distance limb 0 over the live candidates, then limbs
// 1..4 over the candidates still tied (the first-differing-limb rule of
// InfoHash::xorCmp), then the smallest position among the full
// 160-bit ties; the winner leaves the live mask.
//
// Design: one warp per query.  The TPU kernels hold a block of queries
// in vector registers and reduce across lanes; here each thread holds
// its share of the query's candidates in registers (position
// lane + 32*i) and every cross-candidate minimum is one warp-wide
// __reduce_min_sync (sm_80+).  Nothing crosses warps, so there is no
// shared-memory traffic beyond the output staging of window_select.
//
// What bounds them: window_select reads Q*970 words and writes Q*128;
// at k <= 21 its compare/min work per byte is low, so it is meant to be
// memory-bound, but the k sequential rounds of six dependent warp
// reductions put a latency floor under each warp, which the card hides
// only with enough warps in flight (8 per block, Q/8 blocks).
// Fusing the expanded-table row gather into window_select and
// re-shaping both selects for Hopper are later work (ROADMAP.md).
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

// rows   [Q, 5*194] id limbs, limb-planar (lane 0 / 193 = certificate
//        neighbours, lanes 1..192 = the window)
// q8     [Q, 8]     query limbs 0..4 (same bit domain as rows)
// bounds [Q, 8]     col 0 = number of valid window lanes
// out    [Q, 128]   cols [l*k,(l+1)*k) = winners' distance limb l in the
//        sign-flipped domain (u ^ 0x80000000), cols [5k,6k) = winners'
//        local lane (192 once the valid lanes are exhausted), rest 0
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
window_select_kernel(const uint32_t* __restrict__ rows,
                     const uint32_t* __restrict__ q8,
                     const int32_t* __restrict__ bounds,
                     uint32_t* __restrict__ out, int Q, int k) {
  __shared__ uint32_t stage[kWarpsPerBlock][kOutLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + warp;
  if (q >= Q) return;  // the whole warp leaves together

  uint32_t* st = stage[warp];
  for (int c = lane; c < kOutLanes; c += 32) st[c] = 0u;

  const uint32_t* row = rows + static_cast<size_t>(q) * (kLimbs * kErow);
  const int bound = bounds[static_cast<size_t>(q) * 8];
  uint32_t d[kLimbs][kWinPerThread];
  unsigned rem = 0;  // bit i: lane + 32*i is valid and not yet extracted
#pragma unroll
  for (int i = 0; i < kWinPerThread; ++i)
    if (lane + 32 * i < bound) rem |= 1u << i;
#pragma unroll
  for (int l = 0; l < kLimbs; ++l) {
    const uint32_t ql = q8[static_cast<size_t>(q) * 8 + l];
#pragma unroll
    for (int i = 0; i < kWinPerThread; ++i) {
      const int L = lane + 32 * i;
      d[l][i] = (rem >> i & 1u) ? (row[l * kErow + 1 + L] ^ ql) : 0xffffffffu;
    }
  }
  __syncwarp();

  for (int r = 0; r < k; ++r) {
    unsigned t = rem;
    uint32_t ms[kLimbs];
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
      uint32_t local = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < kWinPerThread; ++i)
        if (t >> i & 1u) local = min(local, d[l][i]);
      const uint32_t m = __reduce_min_sync(kFull, local);
      ms[l] = m;
      unsigned nt = 0;
#pragma unroll
      for (int i = 0; i < kWinPerThread; ++i)
        if ((t >> i & 1u) && d[l][i] == m) nt |= 1u << i;
      t = nt;
    }
    int first = kWin;
#pragma unroll
    for (int i = kWinPerThread - 1; i >= 0; --i)
      if (t >> i & 1u) first = lane + 32 * i;
    const int wl = __reduce_min_sync(kFull, first);
    uint32_t v = static_cast<uint32_t>(wl);
#pragma unroll
    for (int l = 0; l < kLimbs; ++l)
      if (lane == l) v = ms[l] ^ 0x80000000u;
    if (lane <= kLimbs) st[lane * k + r] = v;
    if (wl < kWin && (wl & 31) == lane) rem &= ~(1u << (wl >> 5));
  }
  __syncwarp();
  uint32_t* o = out + static_cast<size_t>(q) * kOutLanes;
  for (int c = lane; c < kOutLanes; c += 32) o[c] = st[c];
}

// dist [Q, W, 5] distance limbs in the sign-flipped int32 domain
// inv  [Q, W]    nonzero = never selected
// out  [Q, k]    window positions, -1 once the valid rows run out
template <int NPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lex_select_kernel(const int32_t* __restrict__ dist,
                  const int32_t* __restrict__ inv,
                  int32_t* __restrict__ out, int Q, int W, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + warp;
  if (q >= Q) return;

  const int32_t* dq = dist + static_cast<size_t>(q) * W * kLimbs;
  const int32_t* iq = inv + static_cast<size_t>(q) * W;
  int32_t d[kLimbs][NPT];
  unsigned alive = 0;  // bit i: position lane + 32*i still selectable
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int p = lane + 32 * i;
    const bool in = p < W;
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) d[l][i] = in ? dq[p * kLimbs + l] : INT_MAX;
    if (in && iq[p] == 0) alive |= 1u << i;
  }

  for (int kk = 0; kk < k; ++kk) {
    unsigned cand = alive;
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
      int local = INT_MAX;
#pragma unroll
      for (int i = 0; i < NPT; ++i)
        if (cand >> i & 1u) local = min(local, d[l][i]);
      const int m = __reduce_min_sync(kFull, local);
      unsigned nc = 0;
#pragma unroll
      for (int i = 0; i < NPT; ++i)
        if ((cand >> i & 1u) && d[l][i] == m) nc |= 1u << i;
      cand = nc;
    }
    int first = W;
#pragma unroll
    for (int i = NPT - 1; i >= 0; --i)
      if (cand >> i & 1u) first = lane + 32 * i;
    const int j = __reduce_min_sync(kFull, first);
    if (lane == 0) out[static_cast<size_t>(q) * k + kk] = j < W ? j : -1;
    if (j < W && (j & 31) == lane) alive &= ~(1u << (j >> 5));
  }
}

int blocks_for(int Q) { return (Q + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" int window_select_launch(const void* rows, const void* q8,
                                    const void* bounds, void* out, int Q,
                                    int k, void* stream) {
  if (Q <= 0) return 0;
  window_select_kernel<<<blocks_for(Q), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(q8),
      static_cast<const int32_t*>(bounds), static_cast<uint32_t*>(out), Q, k);
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
