// Monotonic Alignment Search (MAS) for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of mb_istft_vits_tpu/ops/mas_pallas.py:
//   mas_fused_kernel  <- _fused_kernel (DP forward + backtrack in one kernel,
//                        decisions never leave on-chip memory)
//   mas_fwd_kernel    <- _fwd_kernel   (DP forward, decisions to device memory)
//   mas_bwd_kernel    <- _bwd_kernel   (backtrack from those decisions)
// Semantics are those of ops/mas.py:maximum_path_numpy, the transcription of
// the reference Cython DP, bit for bit:
//   shifted = previous row moved right by one (x == 0: 0 on row 0, -1e9 after)
//   v_cur   = previous row, with x == y set to -1e9
//   row     = nc + max(shifted, v_cur) inside the band
//             max(0, t_x + y - t_y) <= x < min(t_x, y + 1), -1e9 outside
//   dec     = (x == y) | (v_cur < shifted)          (strict <)
//   backtrack from x = t_x - 1: emit on rows y < t_y, move left when dec is
//   set and x > 0.
//
// What bounds the DP on this card. Not bytes: the function reads neg_cent
// inside the band once and writes the path once, about 47 us for
// [64, 800, 380] at 3.35 TB/s. The limit is the chain of t_y dependent rows:
// row y needs all of row y - 1, so an item takes t_y times the latency of one
// row, whatever the batch. Every instruction on a row is on that chain, and
// with one warp per item the row costs the time that warp takes to
// dispatch them: measured at ~1.5 cycles per SASS instruction, ~18 instructions per
// 32 columns (PERF.md). So the row step below is cut to the
// instructions the semantics need: v_cur is v (row y - 1 is already -1e9 at
// x == y, outside its band), the x == y decision is one OR per row, and the
// ballot of chunk j reaches lane j by an IMAD with a 0/1 factor.
//
// Design of the DP (mas_fused, mas_fwd). One warp holds an item's row in
// registers: lane l owns columns x = 32 j + l, j < K, with K a template
// parameter in {4, 8, 12, 16}, the smallest with 32 K >= T_x. A row is K
// chunk steps: the left neighbour prev[x - 1] comes from a one-lane rotation
// (__shfl_sync), lane 0 taking lane 31's value of the chunk before; the
// ballot of chunk j is decision word j of the row. There is no block barrier
// and no shared-memory round trip on the chain. Lane j keeps word j and the
// warp stores the row's words in one coalesced store. Rows wider than 512
// columns (up to 8192) take W = ceil(T_x / 512) warps of K = 16, each owning
// 512 contiguous columns; the one value that crosses warps each row goes
// through shared memory behind a named barrier over those W warps only.
//
// neg_cent reaches the DP through a ring of D rows in shared memory, filled
// D rows ahead with 4-byte cp.async (a row of T_x floats need not start on a
// 16-byte boundary, so neither TMA nor 16-byte copies fit), one commit group
// per row. Each lane copies, and later reads, only its own columns inside the
// band, so cp.async.wait_group alone orders the copy before the read.
//
// mas_fused specialises its warps: while the DP warps fill the decision bits
// in shared memory, three more warps zero the item's path slab (16-byte
// stores where aligned). Then warp 0 backtracks and the block writes the
// ones. mas_fwd is the same DP core storing the bits to device memory. One
// item per block: a batch of 16 fills 16 of 132 SMs, and each item's time is
// its own row chain. mas_bwd keeps its first design: one warp backtracks,
// then the block writes the whole path.
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// and passes PyTorch's current stream; each entry point returns the
// cudaError_t of its launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kBwdThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideK = 16;          // chunks per lane on the multi-warp route
constexpr int kMaxWarps = 16;       // T_x <= 16 * 32 * kWideK = 8192
constexpr int kDepth = 8;           // ring rows, one-warp route
constexpr int kWideDepth = 4;       // ring rows, multi-warp route
constexpr int kZeroWarps = 3;       // mas_fused warps that zero the path

__host__ __device__ inline int n_words(int t_x_max) { return (t_x_max + 31) / 32; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte cp.async of src to dst when pred holds.
__device__ __forceinline__ void copy4_if(uint32_t dst, const float* src,
                                         bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
      :: "r"(dst), "l"(src), "r"((int)pred) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// x, hidden from the compiler's value tracking: a 0/1 factor stays a
// register operand of one IMAD instead of becoming a compare and a select
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %1;" : "=r"(x) : "r"(x));
  return x;
}

// Band of row y as (first column, width); width 0 past t_y.
__device__ __forceinline__ void band(int y, int t_y, int t_x, int* lo,
                                     unsigned* width) {
  *lo = max(0, t_x + y - t_y);
  *width = y < t_y ? (unsigned)max(min(t_x, y + 1) - *lo, 0) : 0u;
}

// Copies the in-band cells of row y that this lane owns into the ring.
template <int K>
__device__ __forceinline__ void prefetch_row(const float* src_lane,
                                             uint32_t ring_lane, int x0, int y,
                                             int t_y, int t_x, int T_x) {
  int lo;
  unsigned width;
  band(y, t_y, t_x, &lo, &width);
  const float* src = src_lane + (size_t)y * T_x;
  const int rel = x0 - lo;
#pragma unroll
  for (int j = 0; j < K; ++j)
    copy4_if(ring_lane + 128u * j, src + 32 * j,
             (unsigned)(rel + 32 * j) < width);
}

// The K cells of one ring row that this lane owns.
template <int K>
__device__ __forceinline__ void load_ring_row(float (&out)[K],
                                              const float* row) {
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = row[32 * j];
}

// One DP row of one item by its W warps: v holds row y - 1 on entry and row
// y on return, nc the row's neg_cent (used only inside the band). Returns
// the decision word this lane stores (meaningful on lanes < K).
template <int K, bool kMulti>
__device__ __forceinline__ uint32_t dp_row(float (&v)[K], const float (&nc)[K],
                                           const uint32_t (&is_lane)[K], int y,
                                           int t_y, int t_x, int x0, int wi,
                                           uint32_t valid, float* edge,
                                           int warps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int lo;
  unsigned width;
  band(y, t_y, t_x, &lo, &width);
  const int rel = x0 - lo;           // x - lo at chunk 0
  float left = y == 0 ? 0.f : kNeg;  // prev[x0 - 1] for lane 0 of chunk 0
  if constexpr (kMulti) {
    float* pub = edge + (y & 1) * warps;
    if (lane == 31) pub[warp] = v[K - 1];
    named_barrier(1, 32 * warps);
    if (warp > 0) left = pub[warp - 1];
  }
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float r = __shfl_sync(kFull, v[j], (lane + 31) & 31);
    const float shifted = lane == 0 ? left : r;
    left = r;  // lane 0 of chunk j + 1 takes lane 31 of chunk j
    // v_cur is v: row y - 1's band ends before column y, so v is already
    // -1e9 at x == y, and only the decision needs the x == y rule (below)
    word += __ballot_sync(kFull, v[j] < shifted) * is_lane[j];
    const float cell = nc[j] + fmaxf(shifted, v[j]);
    v[j] = (unsigned)(rel + 32 * j) < width ? cell : kNeg;
  }
  if (wi == (y >> 5)) word |= 1u << (y & 31);  // dec is set at x == y
  return word & valid;
}

// DP forward of one item by its W warps (threads 0 .. 32 W - 1 of the
// block). nc is the item's [T_y, T_x] slab; bits its [T_y, n_words] decision
// words (shared or device memory; rows y >= t_y are not written); ring
// D * 32 K W floats and edge 2 W floats of shared memory.
template <int K, int D, bool kMulti>
__device__ __forceinline__ void dp_forward(const float* __restrict__ nc,
                                           int t_y, int t_x, int T_x,
                                           uint32_t* bits, float* ring,
                                           float* edge, int warps) {
  static_assert((D & (D - 1)) == 0, "ring depth is a power of two");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = n_words(T_x);
  const int stride = 32 * K * warps;         // ring row, floats
  const int x0 = 32 * K * warp + lane;       // column of chunk 0
  const int wi = K * warp + lane;            // word this lane stores
  const int live = T_x - 32 * wi;            // its columns inside T_x
  const uint32_t valid =
      live >= 32 ? kFull : live <= 0 ? 0u : (1u << live) - 1u;
  const bool stores = lane < K && wi < words;
  const float* src_lane = nc + x0;
  const uint32_t ring_lane = smem_addr(ring + x0);

  float v[K];           // previous row, columns x0 + 32 j
  uint32_t is_lane[K];  // 1 on lane j: lane j keeps word j
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v[j] = kNeg;
    is_lane[j] = opaque(lane == j ? 1u : 0u);
  }

#pragma unroll
  for (int r = 0; r < D; ++r) {
    prefetch_row<K>(src_lane, ring_lane + 4u * r * stride, x0, r, t_y, t_x,
                    T_x);
    cp_async_commit();
  }

  for (int y = 0; y < t_y; ++y) {
    cp_async_wait<D - 1>();  // row y has landed
    float nc_row[K];
    load_ring_row<K>(nc_row, ring + (y & (D - 1)) * stride + x0);
    const uint32_t word = dp_row<K, kMulti>(v, nc_row, is_lane, y, t_y, t_x,
                                            x0, wi, valid, edge, warps);
    if (stores) bits[(size_t)y * words + wi] = word;
    // refill the slot of row y with row y + D
    prefetch_row<K>(src_lane, ring_lane + 4u * (y & (D - 1)) * stride, x0,
                    y + D, t_y, t_x, T_x);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// Backtrack of one item, run by the 32 lanes of one warp. Row y's move
// reads the word holding the cursor; in a window of 32 rows the cursor
// moves left at most 31 times, so it stays in the window's top word or the
// one before. The warp loads both words of 32 rows at once (one memory
// round trip per window) and walks them with shuffles. idx[y] receives the
// cursor of every row y < t_y.
__device__ void backtrack_warp(const uint32_t* bits, int words, int t_y,
                               int t_x, int* idx) {
  if (t_x <= 0) return;
  const int lane = threadIdx.x & 31;
  int index = t_x - 1;
  for (int base = t_y - 1; base >= 0; base -= 32) {
    const int w_hi = index >> 5;
    const int y = base - lane;
    uint32_t hi_word = 0, lo_word = 0;
    if (y >= 0) {
      hi_word = bits[(size_t)y * words + w_hi];
      if (w_hi > 0) lo_word = bits[(size_t)y * words + w_hi - 1];
    }
    const int steps = min(32, base + 1);
    for (int j = 0; j < steps; ++j) {
      const uint32_t h = __shfl_sync(kFull, hi_word, j);
      const uint32_t l = __shfl_sync(kFull, lo_word, j);
      if (lane == 0) idx[base - j] = index;
      const uint32_t word = (index >> 5) == w_hi ? h : l;
      if (((word >> (index & 31)) & 1u) && index > 0) --index;
    }
  }
}

// Writes the item's whole [T_y, T_x] path, zeros included: a one at
// (y, idx[y]) and nothing on rows whose idx is -1.
__device__ void write_path(float* __restrict__ path, const int* idx,
                           int T_y, int T_x) {
  const size_t n = (size_t)T_y * T_x;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = (int)(i / T_x);
    const int x = (int)(i - (size_t)y * T_x);
    path[i] = x == idx[y] ? 1.f : 0.f;
  }
}

// Zeroes n floats at p by threads t of nt: scalar stores up to the first
// 16-byte boundary and after the last, float4 stores between.
__device__ void zero_slab(float* __restrict__ p, size_t n, int t, int nt) {
  const size_t head = min(n, (size_t)(((16 - ((uintptr_t)p & 15)) & 15) / 4));
  const size_t n4 = (n - head) / 4;
  float4* body = reinterpret_cast<float4*>(p + head);
  for (size_t i = t; i < head; i += nt) p[i] = 0.f;
  for (size_t i = t; i < n4; i += nt)
    body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = head + 4 * n4 + t; i < n; i += nt) p[i] = 0.f;
}

__device__ inline void item_lengths(const int* t_ys, const int* t_xs, int T_y,
                                    int T_x, int* t_y, int* t_x) {
  *t_y = min(max(t_ys[blockIdx.x], 0), T_y);
  *t_x = min(max(t_xs[blockIdx.x], 0), T_x);
}

// Block: W DP warps, then kZeroWarps warps that zero the path meanwhile.
// Shared memory: ring, edge, bits, idx (mas_fused_shared_bytes). The launch
// bounds (one block per SM, its real size) give ptxas the register budget
// of the launch; without them the DP schedule was slower (PERF.md).
template <int K, int D, bool kMulti>
__global__ void
__launch_bounds__(32 * ((kMulti ? kMaxWarps : 1) + kZeroWarps), 1)
mas_fused_kernel(const float* __restrict__ nc,
                                 const int* __restrict__ t_ys,
                                 const int* __restrict__ t_xs,
                                 float* __restrict__ path, int T_y, int T_x) {
  extern __shared__ float smem[];
  const int warps = (int)(blockDim.x >> 5) - kZeroWarps;
  float* ring = smem;                                        // D * 32 K W
  float* edge = ring + D * 32 * K * warps;                   // 2 W
  uint32_t* bits = reinterpret_cast<uint32_t*>(edge + 2 * warps);
  int* idx = reinterpret_cast<int*>(bits + (size_t)T_y * n_words(T_x));
  int t_y, t_x;
  item_lengths(t_ys, t_xs, T_y, T_x, &t_y, &t_x);
  const size_t item = (size_t)blockIdx.x * T_y * T_x;

  if ((int)threadIdx.x < 32 * warps)
    dp_forward<K, D, kMulti>(nc + item, t_y, t_x, T_x, bits, ring, edge,
                             warps);
  else
    zero_slab(path + item, (size_t)T_y * T_x, threadIdx.x - 32 * warps,
              32 * kZeroWarps);
  __syncthreads();
  if (threadIdx.x < 32) backtrack_warp(bits, n_words(T_x), t_y, t_x, idx);
  __syncthreads();
  if (t_x > 0)  // backtrack_warp set idx[y] for every y < t_y
    for (int y = threadIdx.x; y < t_y; y += blockDim.x)
      path[item + (size_t)y * T_x + idx[y]] = 1.f;
}

// Block: W DP warps. Shared memory: ring, edge. Launch bounds as for
// mas_fused_kernel.
template <int K, int D, bool kMulti>
__global__ void __launch_bounds__(32 * (kMulti ? kMaxWarps : 1), 1)
mas_fwd_kernel(const float* __restrict__ nc,
                               const int* __restrict__ t_ys,
                               const int* __restrict__ t_xs,
                               uint32_t* __restrict__ dec, int T_y, int T_x) {
  extern __shared__ float smem[];
  const int warps = (int)(blockDim.x >> 5);
  float* ring = smem;
  float* edge = ring + D * 32 * K * warps;
  int t_y, t_x;
  item_lengths(t_ys, t_xs, T_y, T_x, &t_y, &t_x);
  dp_forward<K, D, kMulti>(
      nc + (size_t)blockIdx.x * T_y * T_x, t_y, t_x, T_x,
      dec + (size_t)blockIdx.x * T_y * n_words(T_x), ring, edge, warps);
}

__global__ void mas_bwd_kernel(const uint32_t* __restrict__ dec,
                               const int* __restrict__ t_ys,
                               const int* __restrict__ t_xs,
                               float* __restrict__ path, int T_y, int T_x) {
  extern __shared__ int idx[];  // T_y
  const int words = n_words(T_x);
  int t_y, t_x;
  item_lengths(t_ys, t_xs, T_y, T_x, &t_y, &t_x);
  for (int y = threadIdx.x; y < T_y; y += blockDim.x) idx[y] = -1;
  __syncthreads();
  if (threadIdx.x < 32)
    backtrack_warp(dec + (size_t)blockIdx.x * T_y * words, words, t_y, t_x, idx);
  __syncthreads();
  write_path(path + (size_t)blockIdx.x * T_y * T_x, idx, T_y, T_x);
}

// The DP route of a row of T_x columns: chunks per lane, warps per item,
// ring depth, and the kernel instantiations that take it.
struct Route {
  int k, warps, depth;
  void (*fused)(const float*, const int*, const int*, float*, int, int);
  void (*fwd)(const float*, const int*, const int*, uint32_t*, int, int);
};

template <int K>
Route one_warp() {
  return {K, 1, kDepth, mas_fused_kernel<K, kDepth, false>,
          mas_fwd_kernel<K, kDepth, false>};
}

Route route_for(int T_x) {
  if (T_x <= 32 * 4) return one_warp<4>();
  if (T_x <= 32 * 8) return one_warp<8>();
  if (T_x <= 32 * 12) return one_warp<12>();
  if (T_x <= 32 * 16) return one_warp<16>();
  return {kWideK, (T_x + 32 * kWideK - 1) / (32 * kWideK), kWideDepth,
          mas_fused_kernel<kWideK, kWideDepth, true>,
          mas_fwd_kernel<kWideK, kWideDepth, true>};
}

// Ring and edge of the DP, bytes.
long long dp_shared_bytes(const Route& r) {
  return 4LL * r.warps * (32LL * r.k * r.depth + 2);
}

}  // namespace

extern "C" {

// Opt-in shared memory per block of `device` (232,448 bytes on H100).
int mas_max_shared_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* mas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory of the fused kernel: the DP's neg_cent ring and cross-warp
// edge, the decision bits, the path cursor of every row.
long long mas_fused_shared_bytes(int T_y, int T_x) {
  return dp_shared_bytes(route_for(T_x)) +
         4LL * ((long long)T_y * n_words(T_x) + T_y);
}

int mas_max_columns(void) { return kMaxWarps * 32 * kWideK; }

int mas_fused(const float* nc, const int* t_ys, const int* t_xs, float* path,
              int B, int T_y, int T_x, void* stream) {
  const Route r = route_for(T_x);
  const auto kernel = r.fused;
  const size_t smem = (size_t)mas_fused_shared_bytes(T_y, T_x);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<B, 32 * (r.warps + kZeroWarps), smem, (cudaStream_t)stream>>>(
      nc, t_ys, t_xs, path, T_y, T_x);
  return cudaGetLastError();
}

int mas_fwd(const float* nc, const int* t_ys, const int* t_xs, uint32_t* dec,
            int B, int T_y, int T_x, void* stream) {
  const Route r = route_for(T_x);
  const auto kernel = r.fwd;
  const size_t smem = (size_t)dp_shared_bytes(r);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<B, 32 * r.warps, smem, (cudaStream_t)stream>>>(nc, t_ys, t_xs, dec,
                                                          T_y, T_x);
  return cudaGetLastError();
}

int mas_bwd(const uint32_t* dec, const int* t_ys, const int* t_xs, float* path,
            int B, int T_y, int T_x, void* stream) {
  const size_t smem = sizeof(int) * (size_t)T_y;
  cudaError_t e = cudaFuncSetAttribute(
      mas_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mas_bwd_kernel<<<B, kBwdThreads, smem, (cudaStream_t)stream>>>(
      dec, t_ys, t_xs, path, T_y, T_x);
  return cudaGetLastError();
}

}  // extern "C"
