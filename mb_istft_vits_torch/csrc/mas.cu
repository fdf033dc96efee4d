// Monotonic Alignment Search (MAS) for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of mb_istft_vits_tpu/ops/mas_pallas.py:
//   mas_fused_kernel  <- _fused_kernel (DP forward + backtrack in one kernel,
//                        decisions never leave on-chip memory)
//   mas_fwd_kernel    <- _fwd_kernel   (DP forward, decisions to device memory)
//   mas_bwd_kernel,   <- _bwd_kernel   (backtrack from those decisions, then
//   mas_path_kernel                     the path written from its cursors)
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
// its own row chain.
//
// Design of mas_bwd (mas_bwd_kernel, then mas_path_kernel). Its work is
// the backtrack, a chain of t_y dependent rows per item, and the path,
// T_y * T_x floats per item written once. Bytes bound it (the path: 18.7 MB
// at [16, 800, 365], 5.6 us at 3.35 TB/s); the chain is what keeps it above
// that. One SM stores too slowly to write an item's path in the time of its
// backtrack (PERF.md), so the path is written by the whole card: mas_bwd_kernel, one warp per item on an SM
// of its own, backtracks (backtrack_windows) and writes each row's cursor
// to a scratch; mas_path_kernel, launched behind it as a programmatic
// dependent launch, starts at once on the other SMs, zeroes its tile of
// rows with 16-byte stores, waits for the backtrack (griddepcontrol.wait)
// and writes the tile's ones. A backtracked row costs a shift and an add
// on a 32-bit word that a shuffle brought before the cursor got there; the
// words come through a ring of shared memory filled kAhead windows of 32
// rows ahead.
//
// Interface: plain C, loaded with ctypes. The caller allocates every buffer
// and passes PyTorch's current stream; each entry point returns the
// cudaError_t of its launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kTileRows = 32;       // mas_bwd: path rows per block of
constexpr int kTileThreads = 256;   //   mas_path_kernel
constexpr int kAhead = 4;           // mas_bwd: windows of words in flight
constexpr int kSlots = 8;           //   ring slots, a power of two > kAhead
constexpr int kSlotEntries = kAhead + 3;
constexpr int kRingWords = kSlots * kSlotEntries * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideK = 16;          // chunks per lane on the multi-warp route
constexpr int kMaxWarps = 16;       // T_x <= 16 * 32 * kWideK = 8192
constexpr int kDepth = 8;           // ring rows, one-warp route
constexpr int kWideDepth = 4;       // ring rows, multi-warp route
constexpr int kZeroWarps = 3;       // mas_fused warps that zero the path
constexpr int kMaxDevices = 64;     // mas_bwd: devices it remembers set up

__host__ __device__ inline int n_words(int t_x_max) { return (t_x_max + 31) / 32; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte cp.async of src to dst; zeros to dst, reading nothing, unless
// pred holds.
__device__ __forceinline__ void copy4_zfill(uint32_t dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
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

// Backtrack of one item for mas_bwd, by the 32 lanes of one warp, with
// nothing on the cursor's chain waiting for device memory. Window n covers
// rows base = t_y - 1 - 32 n down to base - 31, lane l row base - l. From
// the cursor p0 at the window's top, the window reads columns p0 - 31 ..
// p0 only, so lane l cuts those 32 bits of its row from two decision words
// with one funnel shift: S (bit i = column p0 - 31 + i). With m the moves
// made so far in the window, row j's decision is the top bit of S_j << m,
// and m grows by it: two dependent operations per row. S_j reaches the
// warp by a shuffle that does not wait for the cursor.
//
// The cursor moves at most 32 columns a window, so when window n starts
// with the cursor in word c, window n + k can need only the words
// c - k - 1 .. c. Each lane copies those of its row for window n + kAhead
// into a ring of shared memory with cp.async (zeros outside the item):
// mas_path_kernel floods device memory with stores meanwhile, and under
// that flood a load outlasts one window's walk (PERF.md). While walking
// window n, each lane reads from the ring into registers the three words
// c - 2 .. c that window n + 1 can need, so that a window's start waits on
// no memory. Each lane reads back only the words it copied, so
// cp.async.wait_group alone orders the two. Column 0's decision bit is
// cleared on the way, which keeps the cursor at column 0 once there (the
// rule "move left when x > 0").
//
// Lane l keeps m at row l of the window (one IMAD a row with a 0/1 factor)
// and writes that row's cursor, p0 - m, to cursor[y] when the window ends:
// one coalesced store a window, none on the chain. Rows y >= t_y and words
// outside the item are never read. ring: kRingWords words of shared memory.
__device__ void backtrack_windows(const uint32_t* __restrict__ bits, int words,
                                  int t_y, int t_x, uint32_t* ring,
                                  int* __restrict__ cursor) {
  if (t_x <= 0) return;
  const int lane = threadIdx.x & 31;
  // slot of window n: entries 0 .. kAhead + 1 hold words top - kAhead - 1 ..
  // top of this lane's row, entry kAhead + 2 holds top; entry i of all 32
  // lanes is 32 consecutive words
  const auto slot = [&](int n) {
    return ring + (n & (kSlots - 1)) * kSlotEntries * 32 + lane;
  };
  const auto fetch = [&](int n, int top) {
    const int y = t_y - 1 - 32 * n - lane;
    const uint32_t* row = bits + (size_t)max(y, 0) * words;
    uint32_t* dst = slot(n);
#pragma unroll
    for (int i = 0; i < kAhead + 2; ++i) {
      const int w = top - kAhead - 1 + i;
      copy4_zfill(smem_addr(dst + 32 * i), row + max(w, 0), y >= 0 && w >= 0);
    }
    dst[32 * (kAhead + 2)] = (uint32_t)top;
    cp_async_commit();
  };
  // words c - 2 .. c of window n's rows, read from the ring: w2 = word c
  uint32_t w2, w1, w0;
  const auto take = [&](int n, int c) {
    const uint32_t* src = slot(n);
    const int i = c - (int)src[32 * (kAhead + 2)] + kAhead + 1;
    const uint32_t col0 = ~1u;  // clears bit 0 of word 0
    w2 = src[32 * i] & (c == 0 ? col0 : ~0u);
    w1 = src[32 * (i - 1)] & (c == 1 ? col0 : ~0u);
    w0 = src[32 * (i - 2)] & (c == 2 ? col0 : ~0u);
  };
  uint32_t is_lane[32];  // 1 on lane j: lane j keeps m of row j
#pragma unroll
  for (int j = 0; j < 32; ++j) is_lane[j] = opaque(lane == j ? 1u : 0u);
  int index = t_x - 1;
  int top = index >> 5;  // window n's cursor is in word top or top - 1
  for (int n = 0; n < kAhead; ++n) fetch(n, top);
  cp_async_wait<kAhead - 1>();
  take(0, top);
  for (int base = t_y - 1, n = 0; base >= 0; base -= 32, ++n) {
    const int c = index >> 5;
    const bool at_top = c == top;
    const uint32_t s = __funnelshift_rc(at_top ? w1 : w0, at_top ? w2 : w1,
                                        (index & 31) + 1);
    fetch(n + kAhead, c);
    cp_async_wait<kAhead - 1>();  // window n + 1's words have landed
    take(n + 1, c);
    top = c;
    uint32_t m = 0, mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t s_j = __shfl_sync(kFull, s, j);
      mine += m * is_lane[j];
      m += (s_j << m) >> 31;
    }
    if (base - lane >= 0) cursor[base - lane] = index - (int)mine;
    index -= (int)m;
  }
  cp_async_wait<0>();
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

// mas_bwd, first kernel. Block: one warp, item blockIdx.x. Backtracks and
// writes the cursor of every row y < t_y to cursor[b][y]. It lets
// mas_path_kernel start at once (programmatic dependent launch). Shared
// memory: the ring of backtrack_windows, in the first kRingWords words of
// all that a block may take (see mas_bwd).
__global__ void __launch_bounds__(32, 1)
mas_bwd_kernel(const uint32_t* __restrict__ dec, const int* __restrict__ t_ys,
               const int* __restrict__ t_xs, int* __restrict__ cursor,
               int T_y, int T_x) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  extern __shared__ uint32_t ring[];
  const int words = n_words(T_x);
  int t_y, t_x;
  item_lengths(t_ys, t_xs, T_y, T_x, &t_y, &t_x);
  backtrack_windows(dec + (size_t)blockIdx.x * T_y * words, words, t_y, t_x,
                    ring, cursor + (size_t)blockIdx.x * T_y);
}

// mas_bwd, second kernel. Block (b, tile) writes rows kTileRows * tile ..
// + kTileRows of item b's path whole: the zeros first, while the backtrack
// runs on other SMs, then, once mas_bwd_kernel has finished, the ones.
__global__ void __launch_bounds__(kTileThreads)
mas_path_kernel(const int* __restrict__ t_ys, const int* __restrict__ t_xs,
                const int* __restrict__ cursor, float* __restrict__ path,
                int T_y, int T_x) {
  const int y0 = blockIdx.y * kTileRows;
  const int y1 = min(y0 + kTileRows, T_y);
  const size_t row0 = (size_t)blockIdx.x * T_y;  // item's first row
  zero_slab(path + (row0 + y0) * T_x, (size_t)(y1 - y0) * T_x, threadIdx.x,
            kTileThreads);
  int t_y, t_x;
  item_lengths(t_ys, t_xs, T_y, T_x, &t_y, &t_x);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // cursor is written
  __syncthreads();  // this tile's zeros before its ones
  if (t_x > 0)
    for (int y = y0 + threadIdx.x; y < min(y1, t_y); y += kTileThreads)
      path[(row0 + y) * T_x + cursor[row0 + y]] = 1.f;
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

// Whether a mas_bwd_kernel block, asking for all the shared memory a block
// may take, leaves its SM no room for a mas_path_kernel block: 1 if so, 0
// if not, -1 on error. It does when the SM's shared memory less that block
// and its reserve (each block holds one) is below one more reserve plus
// the path block's static shared memory (H100: 233,472 - (232,448 +
// 1,024) = 0 bytes left).
int mas_bwd_owns_sm(int device) {
  int per_sm = 0, reserved = 0;
  const int per_block = mas_max_shared_bytes(device);
  cudaFuncAttributes path_attr;
  if (per_block < 0 ||
      cudaDeviceGetAttribute(&per_sm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             device) != cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                             device) != cudaSuccess ||
      cudaFuncGetAttributes(&path_attr, mas_path_kernel) != cudaSuccess)
    return -1;
  const long long left = (long long)per_sm - per_block - reserved;
  return left < reserved + (long long)path_attr.sharedSizeBytes ? 1 : 0;
}

// cursor: int32 [B, T_y] scratch. Two launches on the stream: the
// backtrack, then the path writer, allowed to start before the backtrack
// ends (it waits for it with griddepcontrol.wait before the ones). A
// backtrack block asks for all the shared memory a block may take so that
// no path-writer block shares its SM (mas_bwd_owns_sm, checked by
// chip_smoke.py's build): their stores would share the SM's memory
// pipeline with the chain's copies and slow it (PERF.md). The request is
// set once per device.
int mas_bwd(const uint32_t* dec, const int* t_ys, const int* t_xs,
            int* cursor, float* path, int B, int T_y, int T_x, void* stream) {
  static std::atomic<int> bwd_smem[kMaxDevices];  // 0: not set yet
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int smem = bwd_smem[device].load(std::memory_order_relaxed);
  if (smem == 0) {  // two threads may both set it, to the same value
    smem = mas_max_shared_bytes(device);
    e = cudaFuncSetAttribute(mas_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    bwd_smem[device].store(smem, std::memory_order_relaxed);
  }
  mas_bwd_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(dec, t_ys, t_xs, cursor,
                                                        T_y, T_x);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, (T_y + kTileRows - 1) / kTileRows);
  cfg.blockDim = dim3(kTileThreads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mas_path_kernel, t_ys, t_xs,
                         static_cast<const int*>(cursor), path, T_y, T_x);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
