// Segmented sums over sorted slots, five kernels in three families:
//
// * B3, the factored FM backward, and B4, the same backward from per-slot
//   rows (fm_grad_chunks_kernel, then rows_crossing_kernel), below;
// * B5, segment_rowsum, and B6, segment_rowsum_sq (rowsum_chunks_kernel,
//   then rows_crossing_kernel), after them;
// * B7, segment_colsums (colsums_chunks_kernel and
//   colsums_crossing_kernel), last.
//
// All cut the sorted stream into fixed chunks, one warp per chunk, write
// runs that lie inside a chunk straight out, and sum the partial rows of
// runs that cross chunks in a second pass, in a fixed order, without
// atomics. Every launcher takes the card's SM count from its caller, which
// looks it up once per device.
//
// B3. Factored FM backward over id-sorted slots: per-run sums of the FM
// gradient and of its square,
//
//   out[r] = [ sum g_v (k) | sum g_w | sum g_v^2 (k) | sum g_w^2 ]
//   g_v[i] = dsx_i * (s_i - v * x_i) + cv * a_i * v,   g_w[i] = dsx_i + cw * w * a_i
//   dsx_i = ds_i * x_i,   a_i = wt_i if x_i != 0 else 0
//
// over the sorted slots i of run r (seg[i] == r), where (v, w) = vw_u[r]
// is the run's unique row and (s_i, ds_i, wt_i) = ex_srt[i] its example's
// forward sums, loss derivative and weight. Ranks with no slots are zero.
//
// Replaces the TPU kernel sparkfm_tpu/ops/pallas_segsum.py::
// _fm_grad_factored_kernel (called through _fm_grad_factored_pallas, public
// fm_grad_segsum_factored), the backward of the hybrid train step
// (sparkfm_tpu_torch/solvers/sgd_hybrid.py). The TPU kernel runs its grid in
// order with a carry between steps and reduces each subtile with a one-hot
// matrix product; it factors V_u out of the run sums so the (N, k+1)
// per-slot row stream never exists. Here blocks run in no order, so the
// design is different:
//
// What bounds it: bytes. It reads ex_srt (N x (k+2) floats, 87 MB at the
// main path's N = 638,976 and k = 32) once, plus x and seg, and does ~6k
// flops per slot. Two things stand in the way of streaming that at HBM rate:
//
// * Run skew. Hashed zipf ids put a quarter of a batch's slots in one run
//   (162,323 of 638,976 at the main path's recipe), so a warp per run would
//   leave the card idle behind one warp. Pass 1 therefore cuts the sorted
//   stream into fixed chunks of kChunk slots, one warp per chunk. A run
//   that lies inside one chunk is summed by that warp and written to
//   out[r] directly. A run that crosses a chunk boundary leaves one partial
//   row per chunk it touches, in `partials` (two rows per chunk: its first
//   run's, if that run began in an earlier chunk, and its last run's, if
//   that run goes on into the next). Pass 2 runs one block per chunk; the
//   block of the chunk where a crossing run begins sums that run's partials
//   in a fixed order (warps over partial rows, then the warps' sums in warp
//   order) and writes out[r]. No atomics: the sums are the same from run to
//   run.
// * Latency. Within a chunk a warp walks the slots in order; lane f owns
//   factor f (and f + 32, ... for k > 32), lane 0 also owns w. The warp
//   loads the scalars of G slots at once (lane j holds slot j's seg, x, ds,
//   wt and hands them out by shuffle) and the G slots' rows of s before it
//   uses them, so G loads per lane are in flight instead of one.
//
// Numerics: the run's row (v, w) is constant within a run, so each lane
// loads it once per run into registers and forms each slot's gradient
// directly, in f32, and accumulates sum g and sum g^2. This is the exact
// form of the JAX package's XLA branch, without the factored squared-sum
// combine (sum t1^2 - 2 V sum t1 t2 + V^2 sum t2^2) that the JAX note
// warns can cancel. Only the order of the f32 sums differs: sequential
// within a chunk, then chunk by chunk.
//
// A rank outside [0, num_segments) traps the kernel. seg must be sorted
// (the plan's dense ranks are); k is at most 128.
//
// B4. fm_grad_segsum: the same sums from per-slot rows, (v, w) =
// vw_srt[i] for sorted slot i instead of the run's one row. Replaces
// sparkfm_tpu/ops/pallas_segsum.py::_fm_grad_segsum_kernel (called through
// _fm_grad_segsum_pallas, public fm_grad_segsum), which no path of the JAX
// package runs on the TPU (its XLA form is B3's fallback there); here it
// is B3's kernel with one template flag: each slot's row is loaded beside
// its example pack, G slots ahead, so the (N, k+1) row stream adds 4(k+1)
// bytes per slot to what B3 reads.

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kChunk = 256;        // sorted slots per pass-1 work item
constexpr int kThreads1 = 256;         // pass 1: 8 warps, one chunk each
constexpr int kWarps1 = kThreads1 / 32;
constexpr int kThreads2 = 256;         // pass 2: 8 warps per crossing run
constexpr int kWarps2 = kThreads2 / 32;
constexpr int kMaxK = 128;
constexpr int kCols2 = 9;              // pass 2: columns per lane per tile
constexpr int kTile2 = 32 * kCols2;    // pass 2: columns per tile

// KPL factors per lane (k <= 32 * KPL); G slots loaded ahead per step.
// kSlotRows: (v, w) is vw[i] of each sorted slot i (B4), else vw[rank] of
// the run's rank (B3).
template <int KPL, int G, bool kSlotRows>
__global__ void __launch_bounds__(kThreads1)
fm_grad_chunks_kernel(const float* __restrict__ vw,     // (U or N, k+1)
                      const float* __restrict__ ex,     // (N, k+2)
                      const float* __restrict__ x,      // (N,)
                      const int32_t* __restrict__ seg,  // (N,) sorted
                      const float* __restrict__ coef,   // [cv, cw]
                      float* __restrict__ out,          // (U, 2k+2)
                      float* __restrict__ partials,     // (chunks, 2, 2k+2)
                      int64_t n, int64_t num_segments, int k,
                      int64_t num_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t width = 2 * k + 2;
  const int64_t ex_width = k + 2;
  const float cv = coef[0];
  const float cw = coef[1];
  const int64_t num_warps = static_cast<int64_t>(gridDim.x) * kWarps1;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps1 +
                   (threadIdx.x >> 5);
       c < num_chunks; c += num_warps) {
    const int64_t s0 = c * kChunk;
    const int64_t s1 = s0 + kChunk < n ? s0 + kChunk : n;
    const int32_t before = s0 > 0 ? seg[s0 - 1] : -1;
    const int32_t after = s1 < n ? seg[s1] : -1;

    int32_t rank = -1;
    bool first_run = true;
    float g[KPL], sq[KPL], v[KPL];
    float gw = 0.f, sqw = 0.f, w = 0.f;
#pragma unroll
    for (int q = 0; q < KPL; ++q) g[q] = sq[q] = v[q] = 0.f;

    // Writes the sums of the run `rank` to out[rank], or to this chunk's
    // partial row 0 (the run began in an earlier chunk) or 1 (it goes on
    // into the next chunk).
    auto flush = [&](bool last) {
      const bool head = first_run && before == rank;
      const bool tail = last && after == rank;
      float* dst = head   ? partials + (2 * c) * width
                   : tail ? partials + (2 * c + 1) * width
                          : out + static_cast<int64_t>(rank) * width;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int f = lane + 32 * q;
        if (f < k) {
          dst[f] = g[q];
          dst[k + 1 + f] = sq[q];
        }
      }
      if (lane == 0) {
        dst[k] = gw;
        dst[2 * k + 1] = sqw;
      }
    };

    for (int64_t base = s0; base < s1; base += G) {
      const int cnt = static_cast<int>(s1 - base < G ? s1 - base : G);
      int32_t my_seg = 0;
      float my_x = 0.f, my_ds = 0.f, my_wt = 0.f, my_w = 0.f;
      if (lane < cnt) {
        const int64_t i = base + lane;
        my_seg = seg[i];
        my_x = x[i];
        my_ds = ex[i * ex_width + k];
        my_wt = ex[i * ex_width + k + 1];
        if constexpr (kSlotRows) my_w = vw[i * (k + 1) + k];
      }
      float s[G][KPL];
      float vs[kSlotRows ? G : 1][KPL];
#pragma unroll
      for (int t = 0; t < G; ++t) {
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const int f = lane + 32 * q;
          const bool in = t < cnt && f < k;
          s[t][q] = in ? ex[(base + t) * ex_width + f] : 0.f;
          if constexpr (kSlotRows)
            vs[t][q] = in ? vw[(base + t) * (k + 1) + f] : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (t >= cnt) break;                      // cnt is warp-uniform
        const int32_t r = __shfl_sync(kFull, my_seg, t);
        const float xi = __shfl_sync(kFull, my_x, t);
        const float dsi = __shfl_sync(kFull, my_ds, t);
        const float wti = __shfl_sync(kFull, my_wt, t);
        if (r != rank) {
          if (rank >= 0) {
            flush(false);
            first_run = false;
          }
          if (r < 0 || static_cast<int64_t>(r) >= num_segments) __trap();
          rank = r;
#pragma unroll
          for (int q = 0; q < KPL; ++q) g[q] = sq[q] = 0.f;
          gw = sqw = 0.f;
          if constexpr (!kSlotRows) {
            const float* row = vw + static_cast<int64_t>(r) * (k + 1);
#pragma unroll
            for (int q = 0; q < KPL; ++q) {
              const int f = lane + 32 * q;
              v[q] = f < k ? row[f] : 0.f;
            }
            w = row[k];
          }
        }
        if constexpr (kSlotRows) {
          w = __shfl_sync(kFull, my_w, t);
#pragma unroll
          for (int q = 0; q < KPL; ++q) v[q] = vs[t][q];
        }
        const float a = xi != 0.f ? wti : 0.f;
        const float dsx = dsi * xi;
        const float cva = cv * a;
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          const float gv = dsx * (s[t][q] - v[q] * xi) + cva * v[q];
          g[q] += gv;
          sq[q] += gv * gv;
        }
        const float gwi = dsx + cw * w * a;
        gw += gwi;
        sqw += gwi * gwi;
      }
    }
    if (rank >= 0) flush(true);
  }
}

// Pass 2 of B3-B6. One block per chunk c. If a run crosses the end of
// chunk c and began in it, sums that run's partial rows (chunk c's row 1,
// then row 0 of every later chunk the run reaches) in a fixed order into
// out[r], kTile2 columns at a time.
__global__ void __launch_bounds__(kThreads2)
rows_crossing_kernel(const int32_t* __restrict__ seg,
                     const float* __restrict__ partials,
                     float* __restrict__ out, int64_t n, int64_t width,
                     int64_t num_chunks) {
  __shared__ float sums[kWarps2][kTile2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int64_t c = blockIdx.x; c < num_chunks; c += gridDim.x) {
    const int64_t end = (c + 1) * kChunk;         // first slot of chunk c+1
    if (end >= n) continue;                       // the last chunk
    const int32_t r = seg[end - 1];
    if (seg[end] != r) continue;                  // no run crosses
    if (c > 0 && seg[c * kChunk - 1] == r) continue;  // began earlier
    // The run goes on through chunks c+1 .. last: those whose first slot
    // is in it. seg is sorted, so they are a prefix of the later chunks.
    int64_t last = c + 1;
    for (int64_t probe = c + 2;; probe += kThreads2) {
      const int64_t cc = probe + threadIdx.x;
      const int hit = cc < num_chunks && seg[cc * kChunk] == r;
      const int hits = __syncthreads_count(hit);
      last += hits;
      if (hits < kThreads2) break;
    }
    for (int64_t col0 = 0; col0 < width; col0 += kTile2) {
      float acc[kCols2];
#pragma unroll
      for (int q = 0; q < kCols2; ++q) acc[q] = 0.f;
#pragma unroll 4
      for (int64_t j = warp; j <= last - c; j += kWarps2) {
        const float* row =
            partials + (j == 0 ? 2 * c + 1 : 2 * (c + j)) * width + col0;
#pragma unroll
        for (int q = 0; q < kCols2; ++q) {
          const int col = lane + 32 * q;
          if (col0 + col < width) acc[q] += row[col];
        }
      }
#pragma unroll
      for (int q = 0; q < kCols2; ++q) {
        const int col = lane + 32 * q;
        if (col0 + col < width) sums[warp][col] = acc[q];
      }
      __syncthreads();
      if (warp == 0) {
        for (int col = lane; col < kTile2 && col0 + col < width; col += 32) {
          float total = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps2; ++w) total += sums[w][col];
          out[static_cast<int64_t>(r) * width + col0 + col] = total;
        }
      }
      __syncthreads();                            // before sums is reused
    }
  }
}

// Launches pass 2 of B3-B6 over partial rows of `width` floats.
void launch_crossing(const int32_t* seg, const float* partials, float* out,
                     int64_t n, int64_t width, int64_t num_chunks,
                     int num_sms, cudaStream_t stream) {
  if (num_chunks <= 1) return;
  int64_t blocks = num_chunks;
  const int64_t cap = static_cast<int64_t>(num_sms) * 64;
  if (blocks > cap) blocks = cap;
  rows_crossing_kernel<<<static_cast<unsigned>(blocks), kThreads2, 0,
                         stream>>>(seg, partials, out, n, width, num_chunks);
}

template <int KPL, int G, bool kSlotRows>
void launch_chunks(const float* vw, const float* ex, const float* x,
                   const int32_t* seg, const float* coef, float* out,
                   float* partials, int64_t n, int64_t num_segments, int k,
                   int64_t num_chunks, unsigned blocks, cudaStream_t stream) {
  fm_grad_chunks_kernel<KPL, G, kSlotRows><<<blocks, kThreads1, 0, stream>>>(
      vw, ex, x, seg, coef, out, partials, n, num_segments, k, num_chunks);
}

// Both passes of B3 (kSlotRows false) or B4 (true); returns
// cudaGetLastError().
template <bool kSlotRows>
int launch_fm_grad(const float* vw, const float* ex, const float* x,
                   const int32_t* seg, const float* coef, float* out,
                   float* partials, int64_t n, int64_t num_segments,
                   int64_t k, int num_sms, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t num_chunks = (n + kChunk - 1) / kChunk;
  int64_t blocks = (num_chunks + kWarps1 - 1) / kWarps1;
  const int64_t resident = static_cast<int64_t>(num_sms) * (2048 / kThreads1);
  if (blocks > resident) blocks = resident;
  const int ki = static_cast<int>(k);
  const unsigned b1 = static_cast<unsigned>(blocks);
  switch ((ki + 31) / 32) {
    case 1:
      launch_chunks<1, 32, kSlotRows>(vw, ex, x, seg, coef, out, partials, n,
                                      num_segments, ki, num_chunks, b1, s);
      break;
    case 2:
      launch_chunks<2, 16, kSlotRows>(vw, ex, x, seg, coef, out, partials, n,
                                      num_segments, ki, num_chunks, b1, s);
      break;
    case 3:
      launch_chunks<3, 8, kSlotRows>(vw, ex, x, seg, coef, out, partials, n,
                                     num_segments, ki, num_chunks, b1, s);
      break;
    default:
      launch_chunks<4, 8, kSlotRows>(vw, ex, x, seg, coef, out, partials, n,
                                     num_segments, ki, num_chunks, b1, s);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_crossing(seg, partials, out, n, 2 * k + 2, num_chunks, num_sms, s);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// B5. segment_rowsum: per-run sums of the rows of a (N, W) float matrix
// over sorted slots,
//
//   out[r] = sum of g[i] over the slots i with seg[i] == r      (U, W)
//
// and B6, segment_rowsum_sq, which also sums the squares, formed in the
// kernel: out[r] = [ sum g[i] | sum g[i]^2 ]                    (U, 2W)
//
// B5 replaces sparkfm_tpu/ops/pallas_segsum.py::_segsum_kernel (called
// through _segment_rowsum_pallas, public segment_rowsum): the per-unique
// gradient sums of the fused step's accumulate="segsum" (W = 2k+2 = 66,
// or k+3 = 35 under adagrad_row) and of the sorted step (W = 66), in
// sparkfm_tpu_torch/solvers/sgd_fused.py and sgd_sorted.py. B6 replaces
// _segsum_sq_kernel (through _segment_rowsum_sq_pallas, public
// segment_rowsum_sq), which no path of the JAX package runs. The TPU
// kernels reduce each tile with a one-hot matrix product on the MXU and
// carry a run's sum through the ordered grid; B6's bf16x2 split is an MXU
// device with no counterpart here (the sums are f32).
//
// What bounds them: bytes. At the main path's N = 638,976 slots and W = 66
// the kernel reads 169 MB of g and 2.6 MB of seg once and adds once per
// float: a ~50 us floor at 3.35 TB/s. The layout is B3's: lanes own
// columns (lane l owns columns col0 + l, col0 + l + 32, ... of a tile of
// 32 * C columns), so a warp reads each row of its tile with coalesced
// 128-byte loads, G rows ahead; wider rows take more tiles, one per
// blockIdx.y, so any W works (a later FFM slice packs 2 F k + 2 columns).
// Run skew (one ~162k-slot run per zipf batch), the 256-slot chunks per
// warp and pass 2 are B3's. Ranks with no slots are not written: the
// caller zero-fills out. seg must be sorted; a rank outside
// [0, num_segments) traps.

constexpr int64_t kMaxRowWidth = 1 << 16;

// C columns per lane (a tile of 32 * C), G rows loaded ahead per step; SQ
// also sums the squares.
template <int C, int G, bool SQ>
__global__ void __launch_bounds__(kThreads1)
rowsum_chunks_kernel(const float* __restrict__ g,       // (N, w)
                     const int32_t* __restrict__ seg,   // (N,) sorted
                     float* __restrict__ out,           // (U, w or 2w)
                     float* __restrict__ partials,      // (chunks, 2, w or 2w)
                     int64_t n, int64_t num_segments, int64_t w,
                     int64_t num_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t out_width = SQ ? 2 * w : w;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * 32 * C;
  const int64_t num_warps = static_cast<int64_t>(gridDim.x) * kWarps1;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps1 +
                   (threadIdx.x >> 5);
       c < num_chunks; c += num_warps) {
    const int64_t s0 = c * kChunk;
    const int64_t s1 = s0 + kChunk < n ? s0 + kChunk : n;
    const int32_t before = s0 > 0 ? seg[s0 - 1] : -1;
    const int32_t after = s1 < n ? seg[s1] : -1;

    int32_t rank = -1;
    bool first_run = true;
    float acc[C], sq[C];
#pragma unroll
    for (int q = 0; q < C; ++q) acc[q] = sq[q] = 0.f;

    // Writes the sums of the run `rank` to out[rank], or to this chunk's
    // partial row 0 (the run began in an earlier chunk) or 1 (it goes on
    // into the next chunk).
    auto flush = [&](bool last) {
      const bool head = first_run && before == rank;
      const bool tail = last && after == rank;
      float* dst = head   ? partials + (2 * c) * out_width
                   : tail ? partials + (2 * c + 1) * out_width
                          : out + static_cast<int64_t>(rank) * out_width;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int64_t col = col0 + lane + 32 * q;
        if (col < w) {
          dst[col] = acc[q];
          if constexpr (SQ) dst[w + col] = sq[q];
        }
      }
    };

    for (int64_t base = s0; base < s1; base += G) {
      const int cnt = static_cast<int>(s1 - base < G ? s1 - base : G);
      const int32_t my_seg = lane < cnt ? seg[base + lane] : 0;
      float v[G][C];
#pragma unroll
      for (int t = 0; t < G; ++t) {
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int64_t col = col0 + lane + 32 * q;
          v[t][q] = (t < cnt && col < w) ? g[(base + t) * w + col] : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (t >= cnt) break;                      // cnt is warp-uniform
        const int32_t r = __shfl_sync(kFull, my_seg, t);
        if (r != rank) {
          if (rank >= 0) {
            flush(false);
            first_run = false;
          }
          if (r < 0 || static_cast<int64_t>(r) >= num_segments) __trap();
          rank = r;
#pragma unroll
          for (int q = 0; q < C; ++q) acc[q] = sq[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < C; ++q) {
          acc[q] += v[t][q];
          if constexpr (SQ) sq[q] += v[t][q] * v[t][q];
        }
      }
    }
    if (rank >= 0) flush(true);
  }
}

template <int C, int G, bool SQ>
void launch_rowsum_chunks(const float* g, const int32_t* seg, float* out,
                          float* partials, int64_t n, int64_t num_segments,
                          int64_t w, int64_t num_chunks, dim3 grid,
                          cudaStream_t stream) {
  rowsum_chunks_kernel<C, G, SQ><<<grid, kThreads1, 0, stream>>>(
      g, seg, out, partials, n, num_segments, w, num_chunks);
}

// Both passes of B5 (SQ false) or B6 (true); returns cudaGetLastError().
template <bool SQ>
int launch_rowsum(const float* g, const int32_t* seg, float* out,
                  float* partials, int64_t n, int64_t num_segments, int64_t w,
                  int num_sms, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || w > kMaxRowWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t num_chunks = (n + kChunk - 1) / kChunk;
  const int cols = w >= 128 ? 4 : static_cast<int>((w + 31) / 32);
  const int64_t tiles = (w + 32 * cols - 1) / (32 * cols);
  int64_t blocks = (num_chunks + kWarps1 - 1) / kWarps1;
  int64_t resident = static_cast<int64_t>(num_sms) * (2048 / kThreads1) / tiles;
  if (resident < 1) resident = 1;
  if (blocks > resident) blocks = resident;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  switch (cols) {
    case 1:
      launch_rowsum_chunks<1, 32, SQ>(g, seg, out, partials, n, num_segments,
                                      w, num_chunks, grid, s);
      break;
    case 2:
      launch_rowsum_chunks<2, 16, SQ>(g, seg, out, partials, n, num_segments,
                                      w, num_chunks, grid, s);
      break;
    case 3:
      launch_rowsum_chunks<3, 8, SQ>(g, seg, out, partials, n, num_segments,
                                     w, num_chunks, grid, s);
      break;
    default:
      launch_rowsum_chunks<4, 8, SQ>(g, seg, out, partials, n, num_segments,
                                     w, num_chunks, grid, s);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_crossing(seg, partials, out, n, SQ ? 2 * w : w, num_chunks, num_sms,
                  s);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// B7. segment_colsums: per-rank sums of S <= 16 one-dimensional float
// streams over sorted slots,
//
//   out[r * S + j] = sum of streams[j][i] over the slots i with seg[i] == r.
//
// Replaces the TPU kernel sparkfm_tpu/ops/pallas_segsum.py::
// _segsum_streams_kernel (called through _segment_colsums_pallas, public
// segment_colsums): the ALS sweep's per-feature sums
// (sparkfm_tpu_torch/solvers/als.py), S = 1 for a w block and S = 5 for a
// (factor, block), 66 calls per sweep of BASELINE config 2. The TPU kernel
// reduces each subtile with a one-hot matrix product and carries a run's
// sum through its ordered grid.
//
// What bounds it: bytes, (S + 1) * 4 per slot read once (600 MB for a
// block of BASELINE config 2: N = 25M, S = 5, a 179 us floor at 3.35 TB/s),
// against ~S adds per slot. So the design keeps loads in flight and spends
// few instructions per slot:
//
// * Pass 1 gives each chunk of kColChunk sorted slots a one-warp block. The
//   chunk's tiles (as many slots as two buffers of S + 1 arrays fit in 40
//   KB of shared memory) come in by 1-D bulk copies, one per stream plus
//   seg on one mbarrier, double-buffered: lane 0 starts the copies of tile
//   t + 1 before the warp waits for tile t.
// * A tile is cut into steps of 32 V slots. Each lane owns V consecutive
//   slots of a step (V / 4 16-byte shared-memory loads per array; V = 16
//   for S <= 5, 8 for S <= 8, 4 above, as registers allow), sums its own
//   runs in registers in slot order and writes a run that begins and ends
//   inside its slots straight to out. Then ONE segmented inclusive scan
//   over the warp (five shuffle
//   steps keyed on the rank of each lane's last run: seg is sorted, so lane
//   l - d holds part of that run iff its last rank is equal) joins the
//   lanes' open runs; a lane whose first run ends inside its slots adds the
//   scan value of the lane before it, when that lane's last run is the
//   same, and a lane whose last run ends at its last slot writes that
//   run's scan value. The run open after the step's last lane is carried
//   in registers into the next step, where its sum so far is added once,
//   to the run's sum in that step, when the run ends or goes on again (so
//   the lanes' sums stay small and a chunk's carry takes one add per
//   step); it is written when the next step starts with another rank, or
//   at the chunk's end.
// * Alignment. Bulk copies need 16-byte addresses, but seg arrives as a
//   slice of the CSC ranks at offset b * N (solvers/als.py), 16-byte aligned
//   only when N % 4 == 0. Each array's copy starts at the 16-byte boundary
//   at or below the tile's first slot and reads kColPad more floats; the
//   warp then reads that array at its offset past the boundary (scalar
//   shared-memory loads when it is not 0). Tiles whose shifted copy could
//   reach outside [0, N) (the first and the last ones) are read from
//   device memory with scalar loads instead. Nothing reads an unaligned
//   float4.
//
// Run skew: the head movie of the ML-25M-shape data holds a quarter of all
// ratings, 6.4M slots of a 25M block. As in B3, a run that crosses a chunk
// boundary leaves one partial row per chunk it touches (a chunk's row 0:
// its first run, begun in an earlier chunk; row 1: its last run, going on
// into the next). Pass 2 gives each chunk a warp: if a run begins in chunk
// c and crosses into c + 1, the warp finds the chunks it reaches from seg,
// and when that is at most 33 partial rows (almost every crossing run) it
// sums them over its lanes (lane l: rows l, then l + 32) and adds the lanes'
// sums in a fixed butterfly. A longer run is left to the warp's whole block
// of 256 threads, which takes such runs in warp order (one slot per warp),
// sums rows t, t + 256, ... and adds the threads' sums
// in a fixed tree over the S columns. No atomics: the sums repeat bit for
// bit.
//
// Ranks with no slots are not written: the caller zero-fills out. seg must
// be sorted; gaps between ranks are allowed (a block's slice of the CSC
// view holds only that block's ranks). A rank outside [0, num_segments)
// traps.

constexpr int64_t kColChunk = 4096;    // sorted slots per pass-1 block
constexpr int kColPad = 4;             // floats a shifted bulk copy adds
constexpr uint32_t kColSmem = 40 * 1024;  // pass 1's two buffers
constexpr int kMaxStreams = 16;
constexpr int kColThreads2 = 256;      // pass 2: a warp per chunk
constexpr int kColWarps2 = kColThreads2 / 32;

struct Streams {
  const float* p[kMaxStreams];
};

// Pass 1's tile for s streams and V slots per lane: the largest power of
// two from 2048 down to one step (32 V slots) whose two buffers of s + 1
// arrays fit in kColSmem.
int colsums_tile(int s, int v) {
  int tile = 2048;
  while (tile > 32 * v &&
         2u * (s + 1) * (tile + kColPad) * 4 > kColSmem)
    tile /= 2;
  return tile;
}

// SM: s rounded up (1, 2, 4, 5, 8 or 16), the streams held per lane; V:
// consecutive slots per lane, a multiple of 4.
template <int SM, int V>
__global__ void __launch_bounds__(32)
colsums_chunks_kernel(Streams streams, int s,
                      const int32_t* __restrict__ seg,   // (N,) sorted
                      float* __restrict__ out,           // (U, s)
                      float* __restrict__ partials,      // (chunks, 2, s)
                      int64_t n, int64_t num_segments, int tile) {
  extern __shared__ __align__(16) float smem[];  // [2][s + 1][tile + pad]
  __shared__ __align__(8) uint64_t bar[2];
  const int lane = threadIdx.x;
  const int64_t c = blockIdx.x;
  const int64_t s0 = c * kColChunk;
  const int64_t s1 = s0 + kColChunk < n ? s0 + kColChunk : n;
  const int32_t before = s0 > 0 ? seg[s0 - 1] : -1;
  const int32_t after = s1 < n ? seg[s1] : -1;
  const int stride = tile + kColPad;
  // array a: seg (a == 0) or stream a - 1
  auto array = [&](int a) -> const float* {
    return a == 0 ? reinterpret_cast<const float*>(seg) : streams.p[a - 1];
  };
  // floats from the 16-byte boundary below an array's tile start to it;
  // tiles start at multiples of 4 slots, so the same for every tile
  auto shift = [&](int a) -> int {
    return static_cast<int>(reinterpret_cast<uintptr_t>(array(a)) >> 2 & 3);
  };
  // a tile read by bulk copies: the shifted copy stays inside [0, N)
  auto in_smem = [&](int64_t i0) {
    return i0 >= kColPad && i0 + tile + kColPad <= n;
  };
  // lane 0 starts the copies of the tile at slot i0 into buffer b
  auto load = [&](int64_t i0, int b) {
    uint32_t bytes = 0;
#pragma unroll
    for (int a = 0; a <= SM; ++a)
      if (a <= s) bytes += (tile + (shift(a) ? kColPad : 0)) * 4;
    sfm::mbar_expect_bytes(&bar[b], bytes);
#pragma unroll
    for (int a = 0; a <= SM; ++a) {
      if (a <= s) {
        const int sh = shift(a);
        sfm::bulk_load(smem + (b * (s + 1) + a) * stride, array(a) + i0 - sh,
                       (tile + (sh ? kColPad : 0)) * 4, &bar[b]);
      }
    }
  };
  // the sums of the run `rank` to out[rank], or to this chunk's partial
  // row 0 (the run began in an earlier chunk) or row 1 (it goes on)
  auto write = [&](int32_t rank, const float* v, bool may_go_on) {
    float* dst = rank == before                 ? partials + (2 * c) * s
                 : may_go_on && rank == after ? partials + (2 * c + 1) * s
                 : out + static_cast<int64_t>(rank) * s;
#pragma unroll
    for (int q = 0; q < SM; ++q)
      if (q < s) dst[q] = v[q];
  };

  if (lane == 0) {
    sfm::mbar_init(&bar[0], 1);
    sfm::mbar_init(&bar[1], 1);
    sfm::mbar_init_fence();
  }
  __syncwarp();
  const int tiles = static_cast<int>((s1 - s0 + tile - 1) / tile);
  if (lane == 0 && in_smem(s0)) load(s0, 0);
  uint32_t parity = 0;                      // bit b: buffer b's phase
  int32_t carry_rank = -1;                  // the run open after a step
  float carry[SM];
#pragma unroll
  for (int q = 0; q < SM; ++q) carry[q] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int b = t & 1;
    const int64_t i0 = s0 + static_cast<int64_t>(t) * tile;
    // buffer b ^ 1 was read by tile t - 1, which the warp has finished
    if (lane == 0 && t + 1 < tiles && in_smem(i0 + tile))
      load(i0 + tile, b ^ 1);
    const bool from_smem = in_smem(i0);
    if (from_smem) {
      sfm::mbar_wait(&bar[b], parity >> b & 1u);
      parity ^= 1u << b;
    }
    const float* buf = smem + b * (s + 1) * stride;
    const int len = static_cast<int>(s1 - i0 < tile ? s1 - i0 : tile);
    for (int j0 = 0; j0 < len; j0 += 32 * V) {
      const int cnt = len - j0 < 32 * V ? len - j0 : 32 * V;
      const int off = j0 + lane * V;        // the lane's first slot in tile
      int lc = cnt - lane * V;              // the lane's slots
      lc = lc < 0 ? 0 : lc > V ? V : lc;
      int32_t r[V];
      float v[V][SM];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        r[i] = -1;
#pragma unroll
        for (int q = 0; q < SM; ++q) v[i][q] = 0.f;
      }
      if (from_smem) {                      // full tile: lc == V
#pragma unroll
        for (int a = 0; a <= SM; ++a) {
          if (a > s) continue;
          const int sh = shift(a);
          const float* src = buf + a * stride + sh + off;
          float x[V];
          if (sh == 0) {
#pragma unroll
            for (int i = 0; i < V; i += 4) {
              const float4 f = *reinterpret_cast<const float4*>(src + i);
              x[i] = f.x; x[i + 1] = f.y; x[i + 2] = f.z; x[i + 3] = f.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) x[i] = src[i];
          }
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if (a == 0) r[i] = __float_as_int(x[i]);
            else v[i][a > 0 ? a - 1 : 0] = x[i];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (i < lc) {
            const int64_t slot = i0 + off + i;
            r[i] = seg[slot];
#pragma unroll
            for (int q = 0; q < SM; ++q)
              if (q < s) v[i][q] = streams.p[q][slot];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i < lc && (r[i] < 0 || static_cast<int64_t>(r[i]) >= num_segments))
          __trap();
      // the carried run ended where this step starts: write it
      const int32_t first = __shfl_sync(kFull, r[0], 0);
      if (carry_rank >= 0 && first != carry_rank) {
        if (lane == 0) write(carry_rank, carry, false);
        carry_rank = -1;
      }
      // the lane's runs in slot order: head = its first run's sum, acc =
      // the run begun last inside its slots (once `closed`)
      float head[SM], acc[SM];
#pragma unroll
      for (int q = 0; q < SM; ++q) {
        head[q] = v[0][q];
        acc[q] = 0.f;
      }
      bool closed = false;
      int32_t key = lc > 0 ? r[0] : -1;     // the rank of its last run
#pragma unroll
      for (int i = 1; i < V; ++i) {
        if (i >= lc) continue;
        if (r[i] != r[i - 1]) {
          if (closed) {                     // begun and ended in the lane
            float* dst = out + static_cast<int64_t>(r[i - 1]) * s;
#pragma unroll
            for (int q = 0; q < SM; ++q)
              if (q < s) dst[q] = acc[q];
          }
          closed = true;
#pragma unroll
          for (int q = 0; q < SM; ++q) acc[q] = v[i][q];
        } else if (closed) {
#pragma unroll
          for (int q = 0; q < SM; ++q) acc[q] += v[i][q];
        } else {
#pragma unroll
          for (int q = 0; q < SM; ++q) head[q] += v[i][q];
        }
        key = r[i];
      }
      // segmented inclusive scan of the lanes' last runs
      float sc[SM];
#pragma unroll
      for (int q = 0; q < SM; ++q) sc[q] = closed ? acc[q] : head[q];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t kd = __shfl_up_sync(kFull, key, d);
        const bool same = lane >= d && kd == key;
#pragma unroll
        for (int q = 0; q < SM; ++q) {
          if (q < s) {                      // warp-uniform
            const float u = __shfl_up_sync(kFull, sc[q], d);
            if (same) sc[q] += u;
          }
        }
      }
      // a first run that ends inside the lane takes in the lane before's
      const int32_t key_prev = __shfl_up_sync(kFull, key, 1);
      const bool joins = closed && lane > 0 && key_prev == r[0];
#pragma unroll
      for (int q = 0; q < SM; ++q) {
        if (q < s) {
          const float u = __shfl_up_sync(kFull, sc[q], 1);
          if (joins) head[q] = u + head[q];
        }
      }
      // the carried run's earlier steps join it once, where it ends here
      if (closed) {
        if (r[0] == carry_rank) {
#pragma unroll
          for (int q = 0; q < SM; ++q) head[q] = carry[q] + head[q];
        }
        write(r[0], head, false);
      }
      // a run that ends at a lane's last slot, before the step's last lane
      const int last = (cnt - 1) / V;
      const int32_t next_first = __shfl_down_sync(kFull, r[0], 1);
      if (lane < last && next_first != key) {
        if (key == carry_rank) {
#pragma unroll
          for (int q = 0; q < SM; ++q) acc[q] = carry[q] + sc[q];
          write(key, acc, false);
        } else {
          write(key, sc, false);
        }
      }
      // the run open after the step's last lane goes on
      const int32_t open_rank = __shfl_sync(kFull, key, last);
      const bool goes_on = open_rank == carry_rank;
#pragma unroll
      for (int q = 0; q < SM; ++q) {
        if (q < s) {
          const float u = __shfl_sync(kFull, sc[q], last);
          carry[q] = goes_on ? carry[q] + u : u;
        }
      }
      carry_rank = open_rank;
    }
    __syncwarp();                           // done with buffer b
  }
  if (lane == 0 && carry_rank >= 0) write(carry_rank, carry, true);
}

// Row j of the partial rows of the run that begins in chunk c: chunk c's
// row 1, then row 0 of chunk c + j.
__device__ __forceinline__ const float* colsums_partial(
    const float* partials, int64_t c, int64_t j, int s) {
  return partials + (j == 0 ? 2 * c + 1 : 2 * (c + j)) * s;
}

// Pass 2: block g takes chunks 8g .. 8g + 7, one warp each.
__global__ void __launch_bounds__(kColThreads2)
colsums_crossing_kernel(const int32_t* __restrict__ seg,
                        const float* __restrict__ partials,
                        float* __restrict__ out, int64_t n, int s,
                        int64_t num_chunks) {
  __shared__ float red[kMaxStreams][kColThreads2];
  __shared__ int64_t long_runs[kColWarps2];   // warp w's long run, or -1
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  for (int64_t g = blockIdx.x; g * kColWarps2 < num_chunks; g += gridDim.x) {
    if (lane == 0) long_runs[warp] = -1;
    const int64_t c = g * kColWarps2 + warp;
    const int64_t end = (c + 1) * kColChunk;      // first slot of chunk c+1
    int32_t r = -1;
    bool begins = false;                          // a run begins in c, goes on
    if (c < num_chunks && end < n) {
      r = seg[end - 1];
      begins = seg[end] == r && !(c > 0 && seg[c * kColChunk - 1] == r);
    }
    if (begins) {                                 // warp-uniform
      // its rows: chunk c's row 1, chunk c + 1's row 0, and row 0 of the
      // later chunks whose first slot is in it (a prefix: seg is sorted)
      const int64_t cc = c + 2 + lane;
      const unsigned hits = __ballot_sync(
          kFull, cc < num_chunks && seg[cc * kColChunk] == r);
      if (hits != kFull) {
        const int64_t rows = 2 + __popc(hits);
        float acc[kMaxStreams];
#pragma unroll
        for (int q = 0; q < kMaxStreams; ++q) acc[q] = 0.f;
        for (int64_t j = lane; j < rows; j += 32) {
          const float* row = colsums_partial(partials, c, j, s);
#pragma unroll
          for (int q = 0; q < kMaxStreams; ++q)
            if (q < s) acc[q] += row[q];
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
          for (int q = 0; q < kMaxStreams; ++q)
            if (q < s) acc[q] += __shfl_xor_sync(kFull, acc[q], d);
        }
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < kMaxStreams; ++q)
            if (q < s) out[static_cast<int64_t>(r) * s + q] = acc[q];
        }
      } else if (lane == 0) {
        long_runs[warp] = c;
      }
    }
    __syncthreads();
    for (int i = 0; i < kColWarps2; ++i) {        // the block, run by run
      const int64_t lc = long_runs[i];
      if (lc < 0) continue;                       // block-uniform
      const int32_t lr = seg[(lc + 1) * kColChunk - 1];
      int64_t last = lc + 1;
      for (int64_t probe = lc + 2;; probe += kColThreads2) {
        const int64_t cc = probe + t;
        const int hits = __syncthreads_count(
            cc < num_chunks && seg[cc * kColChunk] == lr);
        last += hits;
        if (hits < kColThreads2) break;
      }
      float acc[kMaxStreams];
#pragma unroll
      for (int q = 0; q < kMaxStreams; ++q) acc[q] = 0.f;
      for (int64_t j = t; j <= last - lc; j += kColThreads2) {
        const float* row = colsums_partial(partials, lc, j, s);
#pragma unroll
        for (int q = 0; q < kMaxStreams; ++q)
          if (q < s) acc[q] += row[q];
      }
#pragma unroll
      for (int q = 0; q < kMaxStreams; ++q)
        if (q < s) red[q][t] = acc[q];
      __syncthreads();
      for (int half = kColThreads2 / 2; half > 0; half >>= 1) {
        if (t < half)
          for (int q = 0; q < s; ++q) red[q][t] += red[q][t + half];
        __syncthreads();
      }
      if (t < s) out[static_cast<int64_t>(lr) * s + t] = red[t][0];
      __syncthreads();                            // before red is reused
    }
    __syncthreads();                              // before long_runs is reset
  }
}

template <int SM, int V>
void launch_colsums_chunks(const Streams& streams, int s, const int32_t* seg,
                           float* out, float* partials, int64_t n,
                           int64_t num_segments, int64_t num_chunks,
                           cudaStream_t stream) {
  const int tile = colsums_tile(s, V);
  const size_t smem = 2 * static_cast<size_t>(s + 1) * (tile + kColPad) * 4;
  colsums_chunks_kernel<SM, V><<<static_cast<unsigned>(num_chunks), 32, smem,
                                 stream>>>(streams, s, seg, out, partials, n,
                                           num_segments, tile);
}

}  // namespace

extern "C" {

// Number of partial rows the caller of B3-B6 allocates for N sorted
// slots: two per chunk, each as wide as the output row.
int64_t sfm_chunk_partial_rows(int64_t n) {
  return 2 * ((n + kChunk - 1) / kChunk);
}

// B3 and B4 launch both passes on `stream` and return cudaGetLastError()
// (0 on success). The caller zero-fills `out` (num_segments x (2k+2)),
// allocates `partials` (sfm_chunk_partial_rows(n) x (2k+2)), checks
// shapes and types (1 <= k <= 128), and keeps the tensors alive until the
// stream has run the kernels. B3 reads the unique rows vw_u (num_segments
// x (k+1)), B4 the per-slot rows vw_srt (N x (k+1)).
int sfm_fm_grad_segsum_factored(const float* vw_u, const float* ex,
                                const float* x, const int32_t* seg,
                                const float* coef, float* out,
                                float* partials, int64_t n,
                                int64_t num_segments, int64_t k,
                                int num_sms, void* stream) {
  return launch_fm_grad<false>(vw_u, ex, x, seg, coef, out, partials, n,
                               num_segments, k, num_sms, stream);
}

int sfm_fm_grad_segsum(const float* vw_srt, const float* ex, const float* x,
                       const int32_t* seg, const float* coef, float* out,
                       float* partials, int64_t n, int64_t num_segments,
                       int64_t k, int num_sms, void* stream) {
  return launch_fm_grad<true>(vw_srt, ex, x, seg, coef, out, partials, n,
                              num_segments, k, num_sms, stream);
}

// B5 and B6 launch both passes on `stream` and return cudaGetLastError().
// The caller zero-fills `out` (num_segments x W for B5, x 2W for B6),
// allocates `partials` (sfm_chunk_partial_rows(n) rows of the same
// width), checks shapes and types (1 <= W <= 65536), and keeps the tensors
// alive until the stream has run the kernels.
int sfm_segment_rowsum(const float* g, const int32_t* seg, float* out,
                       float* partials, int64_t n, int64_t num_segments,
                       int64_t w, int num_sms, void* stream) {
  return launch_rowsum<false>(g, seg, out, partials, n, num_segments, w,
                              num_sms, stream);
}

int sfm_segment_rowsum_sq(const float* g, const int32_t* seg, float* out,
                          float* partials, int64_t n, int64_t num_segments,
                          int64_t w, int num_sms, void* stream) {
  return launch_rowsum<true>(g, seg, out, partials, n, num_segments, w,
                             num_sms, stream);
}

// Number of partial rows (of s floats) that the caller allocates for
// segment_colsums over N sorted slots: two per chunk.
int64_t sfm_colsums_partial_rows(int64_t n) {
  return 2 * ((n + kColChunk - 1) / kColChunk);
}

// Launches both passes of segment_colsums on `stream` and returns
// cudaGetLastError() (0 on success). `stream_ptrs` is a host array of s
// device pointers, each to N floats; `seg` and the streams may sit at any
// 4-byte offset. The caller zero-fills `out` (num_segments x s), allocates
// `partials` (sfm_colsums_partial_rows(n) x s), checks shapes and types
// (1 <= s <= 16), and keeps the tensors alive until the stream has run the
// kernels.
int sfm_segment_colsums(const void* stream_ptrs, int64_t s,
                        const int32_t* seg, float* out, float* partials,
                        int64_t n, int64_t num_segments, int num_sms,
                        void* stream) {
  if (n <= 0) return 0;
  if (s < 1 || s > kMaxStreams) return static_cast<int>(cudaErrorInvalidValue);
  Streams streams{};
  const float* const* ptrs = static_cast<const float* const*>(stream_ptrs);
  for (int q = 0; q < s; ++q) streams.p[q] = ptrs[q];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t num_chunks = (n + kColChunk - 1) / kColChunk;
  const int si = static_cast<int>(s);
  if (si == 1) {
    launch_colsums_chunks<1, 16>(streams, si, seg, out, partials, n,
                                 num_segments, num_chunks, st);
  } else if (si == 2) {
    launch_colsums_chunks<2, 16>(streams, si, seg, out, partials, n,
                                 num_segments, num_chunks, st);
  } else if (si <= 4) {
    launch_colsums_chunks<4, 16>(streams, si, seg, out, partials, n,
                                 num_segments, num_chunks, st);
  } else if (si == 5) {
    launch_colsums_chunks<5, 16>(streams, si, seg, out, partials, n,
                                 num_segments, num_chunks, st);
  } else if (si <= 8) {
    launch_colsums_chunks<8, 8>(streams, si, seg, out, partials, n,
                                num_segments, num_chunks, st);
  } else {
    launch_colsums_chunks<16, 4>(streams, si, seg, out, partials, n,
                                 num_segments, num_chunks, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks > 1) {
    int64_t blocks = (num_chunks + kColWarps2 - 1) / kColWarps2;
    const int64_t cap = static_cast<int64_t>(num_sms) * (2048 / kColThreads2);
    if (blocks > cap) blocks = cap;
    colsums_crossing_kernel<<<static_cast<unsigned>(blocks), kColThreads2, 0,
                              st>>>(seg, partials, out, n, si, num_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
