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
// Layout. The TPU kernels transposed to [T_y, B, T_x] to put the batch on
// lanes. Here every batch item is one thread block reading its own contiguous
// [T_y, T_x] slab; one thread per column (a thread takes several columns when
// T_x > 1024). The previous DP row is double-buffered in shared memory, so a
// row costs one __syncthreads(). Decisions are one bit per cell, packed per
// warp with __ballot_sync: [T_y, ceil(T_x / 32)] words per item.
//
// Bound on this card. The function reads neg_cent inside the band once and
// writes the whole path once: for [64, 800, 380] at most 19.5 M cells x 8 B
// = 156 MB, about 47 us at 3.35 TB/s. The kernels do not come near that:
// they are latency-bound on T_y sequential row barriers (each row is a few
// shared-memory round trips plus a barrier), and B = 64 blocks occupy only 64
// of the 132 SMs. The next row's neg_cent is prefetched into registers so the
// device-memory latency overlaps the current row. Spreading one item over
// several SMs or diagonals (Super-MAS, PAPERS.md) is left to a later design.
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// and passes PyTorch's current stream; each entry point returns the
// cudaError_t of its launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxChunks = 8;  // columns per thread: T_x <= 8 * 1024
constexpr int kMaxThreads = 1024;
constexpr int kBwdThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int n_words(int t_x_max) { return (t_x_max + 31) / 32; }

// DP forward of one batch item. `nc` is the item's [T_y, T_x] slab, `bits`
// its [T_y, n_words] decision words (shared or device memory), `rows` 2 * T_x
// floats of shared memory. Rows y >= t_y are all -1e9 and never read by the
// backtrack, so the loop stops at t_y. Ends with a __syncthreads().
__device__ void dp_forward(const float* __restrict__ nc, int t_y, int t_x,
                           int T_x, int words, uint32_t* bits, float* rows) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int nchunks = (T_x + nthr - 1) / nthr;
  for (int x = tid; x < 2 * T_x; x += nthr) rows[x] = kNeg;  // row -1

  float nc_cur[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int x = c * nthr + tid;
    nc_cur[c] = (c < nchunks && t_y > 0 && x < min(t_x, 1)) ? nc[x] : 0.f;
  }
  __syncthreads();

  for (int y = 0; y < t_y; ++y) {
    const float* prev = rows + (y & 1) * T_x;
    float* next = rows + ((y + 1) & 1) * T_x;
    const int lo = max(0, t_x + y - t_y), hi = min(t_x, y + 1);
    // prefetch the next row's band
    const int y1 = y + 1;
    const int lo1 = max(0, t_x + y1 - t_y), hi1 = min(t_x, y1 + 1);
    float nc_nxt[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int x = c * nthr + tid;
      nc_nxt[c] = (c < nchunks && y1 < t_y && x >= lo1 && x < hi1)
                      ? nc[(size_t)y1 * T_x + x] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nchunks) {  // block-uniform: every lane reaches the ballot
        const int x = c * nthr + tid;
        const bool in = x < T_x;
        const float here = in ? prev[x] : kNeg;
        const float shifted =
            x == 0 ? (y == 0 ? 0.f : kNeg) : (in ? prev[x - 1] : kNeg);
        const float v_cur = x == y ? kNeg : here;
        const bool dec = in && (x == y || v_cur < shifted);
        const uint32_t word = __ballot_sync(kFull, dec);
        if (lane == 0 && in) bits[(size_t)y * words + (x >> 5)] = word;
        if (in) next[x] = (x >= lo && x < hi) ? nc_cur[c] + fmaxf(shifted, v_cur) : kNeg;
        nc_cur[c] = nc_nxt[c];
      }
    }
    __syncthreads();
  }
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

__device__ inline void item_lengths(const int* t_ys, const int* t_xs, int T_y,
                                    int T_x, int* t_y, int* t_x) {
  *t_y = min(max(t_ys[blockIdx.x], 0), T_y);
  *t_x = min(max(t_xs[blockIdx.x], 0), T_x);
}

__global__ void mas_fused_kernel(const float* __restrict__ nc,
                                 const int* __restrict__ t_ys,
                                 const int* __restrict__ t_xs,
                                 float* __restrict__ path, int T_y, int T_x) {
  extern __shared__ uint32_t smem[];
  const int words = n_words(T_x);
  uint32_t* bits = smem;                                    // T_y * words
  float* rows = reinterpret_cast<float*>(bits + (size_t)T_y * words);  // 2 T_x
  int* idx = reinterpret_cast<int*>(rows + 2 * T_x);        // T_y
  int t_y, t_x;
  item_lengths(t_ys, t_xs, T_y, T_x, &t_y, &t_x);
  const size_t item = (size_t)blockIdx.x * T_y * T_x;

  dp_forward(nc + item, t_y, t_x, T_x, words, bits, rows);
  for (int y = threadIdx.x; y < T_y; y += blockDim.x) idx[y] = -1;
  __syncthreads();
  if (threadIdx.x < 32) backtrack_warp(bits, words, t_y, t_x, idx);
  __syncthreads();
  write_path(path + item, idx, T_y, T_x);
}

__global__ void mas_fwd_kernel(const float* __restrict__ nc,
                               const int* __restrict__ t_ys,
                               const int* __restrict__ t_xs,
                               uint32_t* __restrict__ dec, int T_y, int T_x) {
  extern __shared__ float rows[];  // 2 * T_x
  const int words = n_words(T_x);
  int t_y, t_x;
  item_lengths(t_ys, t_xs, T_y, T_x, &t_y, &t_x);
  dp_forward(nc + (size_t)blockIdx.x * T_y * T_x, t_y, t_x, T_x, words,
             dec + (size_t)blockIdx.x * T_y * words, rows);
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

int threads_for(int T_x) {
  const int n = (T_x + 31) / 32 * 32;
  return n > kMaxThreads ? kMaxThreads : n;
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

// Shared memory of the fused kernel: decision bits, two DP rows, the path
// cursor of every row.
long long mas_fused_shared_bytes(int T_y, int T_x) {
  return 4LL * ((long long)T_y * n_words(T_x) + 2LL * T_x + T_y);
}

int mas_max_columns(void) { return kMaxChunks * kMaxThreads; }

int mas_fused(const float* nc, const int* t_ys, const int* t_xs, float* path,
              int B, int T_y, int T_x, void* stream) {
  const size_t smem = (size_t)mas_fused_shared_bytes(T_y, T_x);
  cudaError_t e = cudaFuncSetAttribute(
      mas_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mas_fused_kernel<<<B, threads_for(T_x), smem, (cudaStream_t)stream>>>(
      nc, t_ys, t_xs, path, T_y, T_x);
  return cudaGetLastError();
}

int mas_fwd(const float* nc, const int* t_ys, const int* t_xs, uint32_t* dec,
            int B, int T_y, int T_x, void* stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)T_x;
  cudaError_t e = cudaFuncSetAttribute(
      mas_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mas_fwd_kernel<<<B, threads_for(T_x), smem, (cudaStream_t)stream>>>(
      nc, t_ys, t_xs, dec, T_y, T_x);
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
