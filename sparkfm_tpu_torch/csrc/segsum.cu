// Segmented sums over sorted slots, five kernels in three families:
//
// * B3, the factored FM backward, and B4, the same backward from per-slot
//   rows (fm_grad_spans_kernel, then rows_crossing_kernel), below;
// * B5, segment_rowsum, and B6, segment_rowsum_sq, on one staged-tile
//   kernel (rowsum_tiles_kernel, without and with the squares; B5's rows
//   wider than 64 floats on rowsum_chunks_kernel), each then
//   rows_crossing_kernel, after them;
// * B7, segment_colsums (colsums_chunks_kernel and
//   colsums_crossing_kernel), and the ALS stream sums, B7 over five
//   products it forms itself (als_stream_sums_kernel and
//   als_stream_sums_crossing_kernel), after them;
// * and, beside the sums, the compact ALS sweep's patch of q and e after
//   each (factor, block) (als_patch_kernel), last: a streaming pass, no
//   sum.
//
// All the sums cut the sorted stream into chunks (B3/B4: equal spans, one per
// warp; B5's wide rows, B7: fixed chunks; the tiles: chunks that fall
// with N), write runs that lie inside a chunk straight out, and sum the
// partial rows of runs that cross chunks in a second pass, in a fixed
// order, without atomics. Every launcher takes the card's SM count from
// its caller, which looks it up once per device.
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
// design is different.
//
// What bounds it: bytes. It reads ex_srt (N x (k+2) floats, 87 MB at the
// main path's N = 638,976 and k = 32) once, plus x, seg and the unique
// rows, and writes (U, 2k+2): 108 MB, a 32 us floor at 3.35 TB/s, against
// ~8 flops per slot and factor. What stands in the way of streaming it:
//
// * The run's row. Its rank is known only once seg[i] has arrived, and
//   hashed zipf ids make most runs one or two slots long, so a design that
//   loads vw_u[r] when the rank changes pays a dependent round trip on
//   nearly every slot of the tail. Here every row is loaded ahead, by the
//   slot: a warp walks its slots in steps of G (16 at k = 32), lane l
//   owning factors l, l + 32, ...; the step's ranks and scalars (seg, x,
//   ds, wt) were loaded by the step before, so the step first issues the
//   loads of its G slots' example rows and of their rows vw_u[seg[i]]
//   (repeats of a run's row hit L1), then the loads of the next step's
//   ranks and scalars, then does its arithmetic. No slot waits on a load
//   that starts only once its rank is known. The slots' scalar terms go
//   through shared memory, one 16-byte broadcast read per slot, and a
//   ballot marks where runs start, so the per-slot work is the arithmetic
//   and one test of a warp-uniform bit.
// * Issue work. A slot is two row loads and a few multiply-adds, so what
//   a slot costs in instructions sets the pace: the row addresses come
//   from the span's base pointers and 32-bit offsets, one wide
//   multiply-add a load, and a full step loads without predicates. (With
//   64-bit index arithmetic most of a slot's instructions were address
//   arithmetic and the kernel spilled; pass 1 ran half again as long.)
// * Filling the card. Pass 1 cuts the sorted stream into equal spans, one
//   per warp, as many as the card holds at once (3 blocks of 256 threads
//   per SM, the launch bound, which gives a thread 80 registers: at 4
//   blocks and 64 registers the kernel spills and runs slower), so every
//   warp has the same number of slots and one wave covers the stream: at
//   the main path's shape 3,072 spans of 208 slots. (A second layout, 16
//   lanes a slot and two spans a warp for k <= 32, ran pass 1 about as
//   fast but doubled pass 2's partial rows: slower in all, on the H100;
//   PERF.md keeps its times.)
// * Run skew. Hashed zipf ids put a quarter of a batch's slots in one run
//   (162,323 of 638,976 at the main path's recipe). A run that lies inside
//   one span is summed by its warp and written to out[r] directly. A run
//   that crosses a span boundary leaves one partial row per span it
//   touches, in `partials` (two rows per span: its first run's, if that
//   run began in an earlier span, and its last run's, if that run goes on
//   into the next). Pass 2 (rows_crossing_kernel, below, shared with B4-B6)
//   sums them.
//
// Numerics: each lane forms each slot's gradient directly, in f32, from
// the slot's row and accumulates sum g and sum g^2: the exact form of the
// JAX package's XLA branch, without the factored squared-sum combine (sum
// t1^2 - 2 V sum t1 t2 + V^2 sum t2^2) that the JAX note warns can cancel.
// The order of the f32 sums: sequential in slot order within a span; a
// crossing run's partial rows then in pass 2's order (below). No atomics:
// the sums repeat bit for bit.
//
// What holds it, measured on the H100 (PERF.md): ~51% of the bound at the
// main path's shape, pass 1 ~50 us and pass 2 ~14 us. Pass 1 is still
// held by per-slot issue work rather than bytes; staging rows in shared
// memory by bulk copies, a slab of a step's unique rows, and 8 to 16
// slots a step did not beat it. B7's layout (lanes over slots, each
// tile's example rows, values, ranks and unique rows by bulk copy,
// double-buffered, four one-warp blocks an SM as shared memory allows)
// was no faster in a prototype even before its run bookkeeping: with one
// warp a scheduler, its arithmetic from shared memory did not hide behind
// the copies. Pass 2 is set by the head run's ~800 partial rows, which
// one block sums.
//
// A rank outside [0, num_segments) traps the kernel before its row is
// read. seg must be sorted (the plan's dense ranks are); k is at most 128.
//
// B4. fm_grad_segsum: the same sums from per-slot rows, (v, w) =
// vw_srt[i] for sorted slot i instead of the run's one row. Replaces
// sparkfm_tpu/ops/pallas_segsum.py::_fm_grad_segsum_kernel (called through
// _fm_grad_segsum_pallas, public fm_grad_segsum), which no path of the JAX
// package runs on the TPU (its XLA form is B3's fallback there); here it
// is B3's kernel with one template flag: the row of slot i is vw[i]
// instead of vw[seg[i]], so the (N, k+1) row stream adds 4(k+1) bytes per
// slot to what B3 reads.
//
// Pass 2 of B3-B6 (rows_crossing_kernel): B7's design for rows of any
// width. A block of 32 warps takes 32 consecutive chunks (spans), a warp
// each. If a run begins in chunk c and crosses into c + 1, the warp finds
// the chunks it reaches from seg (a ballot over the next 32 chunks'
// first slots); when that is at most 33 partial rows (almost every
// crossing run) the warp sums them with lanes over columns, row by row in
// order. A longer run is left to the warp's whole block, which takes such
// runs in warp order (one slot per warp): warp w sums rows w, w + 32, ...
// in order, lanes over columns, and warp 0 adds the 32 warps' sums in
// warp order. No atomics. For B3, B4 and B5's chunked layout pass 2
// also writes the zero rows of the ranks no slot has (a warp those before
// the runs that begin in its chunk, found by comparing neighbouring
// ranks, and a slice of those past seg[n - 1]), so the output is written
// once and not filled first (the same writes in B3's pass 1 slowed its
// loop by taking registers; here they cost ~2 us at the main path's
// shape, against ~3.5 us for filling the output). The staged tiles' pass
// 1 (B5, B6) writes them itself.

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kChunk = 256;        // B5 wide rows: slots a warp (the
                                       // wrapper's ROWSUM_CHUNK)
constexpr int kThreads1 = 256;         // pass 1: 8 warps a block
constexpr int kWarps1 = kThreads1 / 32;
constexpr int kBlocks1 = 3;            // B3/B4: resident blocks per SM
constexpr int kThreads2 = 1024;        // pass 2: 32 chunks a block
constexpr int kWarps2 = kThreads2 / 32;
constexpr int kMaxK = 128;
constexpr int kCols2 = 3;              // pass 2, long runs: columns per lane
constexpr int kTile2 = 32 * kCols2;    // pass 2, long runs: columns per tile

// G, the slots a warp loads ahead per step, for KPL factors per lane:
// 2 G KPL row values in registers, within the launch bound's 80 a
// thread.
constexpr int fm_grad_step(int kpl) {
  return kpl == 1 ? 16 : kpl == 2 ? 8 : 4;
}

// B3/B4's span: n slots cut into as many equal spans, one per warp, as
// the card holds at once (kBlocks1 blocks an SM), each a multiple of G
// slots at width k.
int64_t fm_grad_span(int64_t n, int64_t k, int num_sms) {
  const int step = fm_grad_step(static_cast<int>((k + 31) / 32));
  const int64_t warps = static_cast<int64_t>(num_sms) * kBlocks1 * kWarps1;
  const int64_t span = ((n + warps - 1) / warps + step - 1) / step * step;
  return span < step ? step : span;
}

// Pass 1 of B3 (kSlotRows false: the row of slot i is vw[seg[i]]) and B4
// (true: vw[i]). A warp per span; KPL factors per lane (k <= 32 KPL); G
// slots per step. A step:
//   1. the loads of its G slots' example rows and rows (v, w), by the ranks
//      the step before loaded, then of the next step's ranks and scalars;
//   2. lane j < G forms slot j's scalar terms, ds x, x, cv a and g_w = ds x
//      + cw w a, and puts them and the rank in the warp's shared-memory
//      slot j; a ballot marks the slots that start a run;
//   3. the warp adds the G slots in order, lanes over factors, each slot's
//      terms one 16-byte broadcast read; a run's sums are written where the
//      next run starts. Past the span's end the terms and rows are zero and
//      add nothing.
// Row addresses come from the span's base pointers and 32-bit offsets (one
// wide multiply-add a load), and a full step loads without predicates: a
// lane past k reads column k - 1, and its sums are never written.
template <int KPL, int G, bool kSlotRows>
__global__ void __launch_bounds__(kThreads1, kBlocks1)
fm_grad_spans_kernel(const float* __restrict__ vw,     // (U or N, k+1)
                     const float* __restrict__ ex,     // (N, k+2)
                     const float* __restrict__ x,      // (N,)
                     const int32_t* __restrict__ seg,  // (N,) sorted
                     const float* __restrict__ cv_p,   // () L2 coefficients
                     const float* __restrict__ cw_p,   // ()
                     float* __restrict__ out,          // (U, 2k+2)
                     float* __restrict__ partials,     // (spans, 2, 2k+2)
                     int64_t n, int64_t num_segments, int k, int64_t span,
                     int64_t num_spans) {
  static_assert(G <= 32, "a step's slots sit one per lane");
  __shared__ float4 terms[kWarps1][G];  // per slot: ds x, x, cv a, g_w
  __shared__ int32_t ranks[kWarps1][G];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* const tw = terms[warp];
  int32_t* const rw = ranks[warp];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps1 + warp;
  if (c >= num_spans) return;                        // warp-uniform
  const int64_t s0 = c * span;
  const int len = static_cast<int>(n - s0 < span ? n - s0 : span);
  const int32_t before = s0 > 0 ? seg[s0 - 1] : -1;
  const int32_t after = s0 + len < n ? seg[s0 + len] : -1;
  const int width = 2 * k + 2;
  const int ex_width = k + 2;
  const int vw_width = k + 1;
  const uint32_t ex_bytes = static_cast<uint32_t>(ex_width) * 4u;
  const uint32_t vw_bytes = static_cast<uint32_t>(vw_width) * 4u;
  const float cv = *cv_p;
  const float cw = *cw_p;
  const float* const ex_s = ex + s0 * ex_width;      // this span's slots
  const float* const x_s = x + s0;
  const int32_t* const seg_s = seg + s0;
  const float* const vw_s = kSlotRows ? vw + s0 * vw_width : vw;
  float* const head_row = partials + 2 * c * width;
  float* const tail_row = head_row + width;
  int fl[KPL];                                       // the lane's columns
#pragma unroll
  for (int q = 0; q < KPL; ++q) {
    const int f = lane + 32 * q;
    fl[q] = f < k ? f : k - 1;
  }

  int32_t rank = -1;
  bool first_run = true;
  float g[KPL], sq[KPL];
  float gw = 0.f, sqw = 0.f;
#pragma unroll
  for (int q = 0; q < KPL; ++q) g[q] = sq[q] = 0.f;

  // Writes the sums of the run `rank` to out[rank], or to this span's
  // partial row 0 (the run began in an earlier span) or 1 (it goes on
  // into the next span).
  auto flush = [&](bool last) {
    const bool head = first_run && before == rank;
    const bool tail = last && after == rank;
    float* dst = head   ? head_row
                 : tail ? tail_row
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

  // lane j < G: the rank and scalars of slot o + j of the span (a rank out
  // of range traps here, before its row is read)
  int32_t my_seg = 0;
  float my_x = 0.f, my_ds = 0.f, my_wt = 0.f;
  auto load_scalars = [&](int o) {
    const int i = o + lane;
    my_seg = 0;
    my_x = my_ds = my_wt = 0.f;
    if (lane < G && i < len) {
      my_seg = seg_s[i];
      if (my_seg < 0 || static_cast<int64_t>(my_seg) >= num_segments)
        __trap();
      my_x = x_s[i];
      const float* e = ex_s + static_cast<int64_t>(i) * ex_width + k;
      my_ds = e[0];
      my_wt = e[1];
    }
  };

  load_scalars(0);
  for (int off = 0; off < len; off += G) {           // warp-uniform
    const int cnt = len - off < G ? len - off : G;
    const int32_t cur_seg = my_seg;
    const float cur_x = my_x, cur_ds = my_ds, cur_wt = my_wt;
    // 1. this step's rows, all in flight, then the next step's scalars
    float s[G][KPL], v[G][KPL];
    if (cnt == G) {
      const char* const ex_t =
          reinterpret_cast<const char*>(ex_s + fl[0]) +
          static_cast<uint64_t>(static_cast<uint32_t>(off)) * ex_bytes;
      const char* const vw_t = reinterpret_cast<const char*>(
          (kSlotRows ? vw_s + static_cast<int64_t>(off) * vw_width : vw) +
          fl[0]);
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const float* er = reinterpret_cast<const float*>(
            ex_t + static_cast<uint64_t>(static_cast<uint32_t>(t)) * ex_bytes);
        const uint32_t row =
            kSlotRows ? static_cast<uint32_t>(t)
                      : static_cast<uint32_t>(__shfl_sync(kFull, cur_seg, t));
        const float* vr = reinterpret_cast<const float*>(
            vw_t + static_cast<uint64_t>(row) * vw_bytes);
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          s[t][q] = __ldg(er + (fl[q] - fl[0]));
          v[t][q] = __ldg(vr + (fl[q] - fl[0]));
        }
      }
    } else {                                         // the last span's tail
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int32_t r = __shfl_sync(kFull, cur_seg, t);
        const float* er = ex_s + static_cast<int64_t>(off + t) * ex_width;
        const float* vr =
            kSlotRows ? vw_s + static_cast<int64_t>(off + t) * vw_width
                      : vw + static_cast<int64_t>(r) * vw_width;
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          s[t][q] = t < cnt ? __ldg(er + fl[q]) : 0.f;
          v[t][q] = t < cnt ? __ldg(vr + fl[q]) : 0.f;
        }
      }
    }
    float my_w = 0.f;
    if (lane < cnt)
      my_w = kSlotRows ? vw_s[static_cast<int64_t>(off + lane) * vw_width + k]
                       : vw[static_cast<int64_t>(cur_seg) * vw_width + k];
    load_scalars(off + G);
    // 2. slot j's terms, and the slots that start a run
    const int32_t prev = __shfl_up_sync(kFull, cur_seg, 1);
    const bool starts = lane < cnt && cur_seg != (lane == 0 ? rank : prev);
    const unsigned bounds = __ballot_sync(kFull, starts);
    __syncwarp();                           // the last step's reads are done
    if (lane < G) {
      const float a = cur_x != 0.f ? cur_wt : 0.f;
      const float dsx = cur_ds * cur_x;
      tw[lane] = make_float4(dsx, cur_x, cv * a, dsx + cw * my_w * a);
      rw[lane] = cur_seg;
    }
    __syncwarp();
    // 3. the slots in order
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const float4 term = tw[t];
      if (bounds >> t & 1u) {               // warp-uniform
        if (rank >= 0) {
          flush(false);
          first_run = false;
        }
        rank = rw[t];
#pragma unroll
        for (int q = 0; q < KPL; ++q) g[q] = sq[q] = 0.f;
        gw = sqw = 0.f;
      }
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const float gv =
            term.x * (s[t][q] - v[t][q] * term.y) + term.z * v[t][q];
        g[q] += gv;
        sq[q] += gv * gv;
      }
      gw += term.w;
      sqw += term.w * term.w;
    }
  }
  if (rank >= 0) flush(true);
}

// Row j of the partial rows of the run that begins in chunk c: chunk c's
// row 1, then row 0 of chunk c + j.
__device__ __forceinline__ const float* crossing_row(const float* partials,
                                                     int64_t c, int64_t j,
                                                     int64_t width) {
  return partials + (j == 0 ? 2 * c + 1 : 2 * (c + j)) * width;
}

// Adds rows j0, j0 + stride, ... < j1 of the partial rows of the run that
// begins in chunk c into acc, in that order, at columns col0 + lane + 32q
// (q < kCols2), with kBatch rows' loads in flight at a time (the adds of
// the zeros that pad a batch change nothing).
template <int kBatch>
__device__ __forceinline__ void add_rows(const float* partials, int64_t c,
                                         int64_t j0, int64_t j1,
                                         int64_t stride, int64_t width,
                                         int64_t col0, int lane,
                                         float (&acc)[kCols2]) {
  for (int64_t j = j0; j < j1; j += kBatch * stride) {
    float v[kBatch][kCols2];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int64_t jj = j + b * stride;
#pragma unroll
      for (int q = 0; q < kCols2; ++q) {
        const int64_t col = col0 + lane + 32 * q;
        v[b][q] = jj < j1 && col < width
                      ? crossing_row(partials, c, jj, width)[col]
                      : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int q = 0; q < kCols2; ++q) acc[q] += v[b][q];
    }
  }
}

// Writes the zero rows of the ranks that lie between seg[i - 1] and seg[i]
// for the slots i in [i0, i1) (those before seg[0] when i0 is 0). A warp
// takes 32 kScan slots a round, their loads issued together; a lane writes
// a gap's rows alone, as gaps are rare (the plans' ranks are dense).
constexpr int kScan = 8;
__device__ __forceinline__ void zero_gaps(const int32_t* __restrict__ seg,
                                          float* __restrict__ out,
                                          int64_t i0, int64_t i1,
                                          int64_t width, int lane) {
  for (int64_t b = i0; b < i1; b += 32 * kScan) {         // warp-uniform
    const int32_t prior = b > 0 ? seg[b - 1] : -1;
    int32_t r[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int64_t i = b + u * 32 + lane;
      r[u] = i < i1 ? seg[i] : INT32_MIN;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int32_t up = __shfl_up_sync(kFull, r[u], 1);
      const int32_t carry =
          u > 0 ? __shfl_sync(kFull, r[u > 0 ? u - 1 : 0], 31) : prior;
      const int32_t left = lane > 0 ? up : carry;
      for (int64_t z = static_cast<int64_t>(left) + 1; z < r[u]; ++z)
        for (int64_t col = 0; col < width; ++col) out[z * width + col] = 0.f;
    }
  }
}

// Pass 2 of B3-B6 over chunks of `chunk` slots: block g takes chunks
// 32g .. 32g + 31, one warp each (the design is in the note above). With
// `zeros` it also writes the zero rows of the ranks no slot has, so the
// caller need not fill out: warp c those before the runs that begin in
// chunk c, and every warp its slice of the ranks past seg[n - 1] (the
// staged tiles call it without `zeros`: their pass 1 writes them).
__global__ void __launch_bounds__(kThreads2)
rows_crossing_kernel(const int32_t* __restrict__ seg,
                     const float* __restrict__ partials,
                     float* __restrict__ out, int64_t n,
                     int64_t num_segments, int64_t width, int64_t chunk,
                     int64_t num_chunks, bool zeros) {
  __shared__ float sums[kWarps2][kTile2];
  __shared__ int64_t long_runs[kWarps2];      // warp w's long run, or -1
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  for (int64_t g = blockIdx.x; g * kWarps2 < num_chunks; g += gridDim.x) {
    if (lane == 0) long_runs[warp] = -1;
    const int64_t c = g * kWarps2 + warp;
    if (zeros && c < num_chunks)                  // warp-uniform
      zero_gaps(seg, out, c * chunk, (c + 1) * chunk < n ? (c + 1) * chunk : n,
                width, lane);
    const int64_t end = (c + 1) * chunk;          // first slot of chunk c+1
    int32_t r = -1;
    bool begins = false;                          // a run begins in c, goes on
    if (c < num_chunks && end < n) {
      r = seg[end - 1];
      begins = seg[end] == r && !(c > 0 && seg[c * chunk - 1] == r);
    }
    if (begins) {                                 // warp-uniform
      // its rows: chunk c's row 1, chunk c + 1's row 0, and row 0 of the
      // later chunks whose first slot is in it (a prefix: seg is sorted)
      const int64_t cc = c + 2 + lane;
      const unsigned hits = __ballot_sync(
          kFull, cc < num_chunks && seg[cc * chunk] == r);
      if (hits != kFull) {
        const int64_t rows = 2 + __popc(hits);
        float* dst = out + static_cast<int64_t>(r) * width;
        for (int64_t col0 = 0; col0 < width; col0 += kTile2) {
          float acc[kCols2] = {};
          add_rows<8>(partials, c, 0, rows, 1, width, col0, lane, acc);
#pragma unroll
          for (int q = 0; q < kCols2; ++q) {
            const int64_t col = col0 + lane + 32 * q;
            if (col < width) dst[col] = acc[q];
          }
        }
      } else if (lane == 0) {
        long_runs[warp] = c;
      }
    }
    __syncthreads();
    for (int i = 0; i < kWarps2; ++i) {           // the block, run by run
      const int64_t lc = long_runs[i];
      if (lc < 0) continue;                       // block-uniform
      const int32_t lr = seg[(lc + 1) * chunk - 1];
      int64_t last = lc + 1;
      for (int64_t probe = lc + 2;; probe += kThreads2) {
        const int64_t cc = probe + t;
        const int hits = __syncthreads_count(
            cc < num_chunks && seg[cc * chunk] == lr);
        last += hits;
        if (hits < kThreads2) break;
      }
      for (int64_t col0 = 0; col0 < width; col0 += kTile2) {
        float acc[kCols2] = {};
        add_rows<12>(partials, lc, warp, last - lc + 1, kWarps2, width,
                     col0, lane, acc);
#pragma unroll
        for (int q = 0; q < kCols2; ++q) sums[warp][lane + 32 * q] = acc[q];
        __syncthreads();
        if (warp == 0) {
          for (int col = lane; col < kTile2 && col0 + col < width;
               col += 32) {
            float total = 0.f;
#pragma unroll 8
            for (int w = 0; w < kWarps2; ++w) total += sums[w][col];
            out[static_cast<int64_t>(lr) * width + col0 + col] = total;
          }
        }
        __syncthreads();                          // before sums is reused
      }
    }
    __syncthreads();                              // before long_runs is reset
  }
  if (!zeros) return;
  // the ranks past the last slot's (pass 1 has trapped on one out of range)
  const int64_t f0 = (static_cast<int64_t>(seg[n - 1]) + 1) * width;
  const int64_t f1 = num_segments * width;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps2;
  const int64_t per = f1 > f0 ? (f1 - f0 + warps - 1) / warps : 0;
  const int64_t mine = f0 + (static_cast<int64_t>(blockIdx.x) * kWarps2 +
                             warp) * per;
  for (int64_t f = mine + lane; f < mine + per && f < f1; f += 32)
    out[f] = 0.f;
}

// Launches pass 2 of B3-B6 over partial rows of `width` floats, two per
// chunk of `chunk` slots; with `zeros` it runs for a single chunk too, for
// the zero rows.
void launch_crossing(const int32_t* seg, const float* partials, float* out,
                     int64_t n, int64_t num_segments, int64_t width,
                     int64_t chunk, int64_t num_chunks, int num_sms,
                     bool zeros, cudaStream_t stream) {
  if (!zeros && num_chunks < 2) return;
  int64_t blocks = (num_chunks + kWarps2 - 1) / kWarps2;
  const int64_t cap = static_cast<int64_t>(num_sms) * (2048 / kThreads2);
  if (blocks > cap) blocks = cap;
  rows_crossing_kernel<<<static_cast<unsigned>(blocks), kThreads2, 0,
                         stream>>>(seg, partials, out, n, num_segments, width,
                                   chunk, num_chunks, zeros);
}

template <int KPL, bool kSlotRows>
void launch_spans(const float* vw, const float* ex, const float* x,
                  const int32_t* seg, const float* cv, const float* cw,
                  float* out, float* partials, int64_t n,
                  int64_t num_segments, int k, int64_t span,
                  int64_t num_spans, cudaStream_t stream) {
  const int64_t blocks = (num_spans + kWarps1 - 1) / kWarps1;
  fm_grad_spans_kernel<KPL, fm_grad_step(KPL), kSlotRows>
      <<<static_cast<unsigned>(blocks), kThreads1, 0, stream>>>(
          vw, ex, x, seg, cv, cw, out, partials, n, num_segments, k, span,
          num_spans);
}

// Both passes of B3 (kSlotRows false) or B4 (true); returns
// cudaGetLastError().
template <bool kSlotRows>
int launch_fm_grad(const float* vw, const float* ex, const float* x,
                   const int32_t* seg, const float* cv, const float* cw,
                   float* out, float* partials, int64_t n,
                   int64_t num_segments, int64_t k, int num_sms,
                   void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t span = fm_grad_span(n, k, num_sms);
  const int64_t num_spans = (n + span - 1) / span;
  const int ki = static_cast<int>(k);
  switch ((ki + 31) / 32) {
    case 1:
      launch_spans<1, kSlotRows>(vw, ex, x, seg, cv, cw, out, partials, n,
                                 num_segments, ki, span, num_spans, s);
      break;
    case 2:
      launch_spans<2, kSlotRows>(vw, ex, x, seg, cv, cw, out, partials, n,
                                 num_segments, ki, span, num_spans, s);
      break;
    case 3:
      launch_spans<3, kSlotRows>(vw, ex, x, seg, cv, cw, out, partials, n,
                                 num_segments, ki, span, num_spans, s);
      break;
    default:
      launch_spans<4, kSlotRows>(vw, ex, x, seg, cv, cw, out, partials, n,
                                 num_segments, ki, span, num_spans, s);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_crossing(seg, partials, out, n, num_segments, 2 * k + 2, span,
                  num_spans, num_sms, true, s);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// B5. segment_rowsum: per-run sums of the rows of a (N, W) float matrix
// over sorted slots,
//
//   out[r] = sum of g[i] over the slots i with seg[i] == r      (U, W)
//
// B5 replaces sparkfm_tpu/ops/pallas_segsum.py::_segsum_kernel (called
// through _segment_rowsum_pallas, public segment_rowsum). The TPU kernel
// reduces each tile with a one-hot matrix product on the MXU and carries
// a run's sum through the ordered grid. Its callers in the port, since B6
// took the [g | g^2] packs: the fused step's adagrad_row pack (W = k + 3:
// 35 at rank 32, over a ladder plan, U = 40,960;
// sparkfm_tpu_torch/solvers/sgd_fused.py) and the direct step's per-slot
// momentum and adam terms (W = vk + 1: 33 at rank 32, 17 at BASELINE
// config 5, 9 at config 1) over the step's own plan, whose budget is N
// (solvers/sgd.py; also the sharded dense exchange and DeepFM's direct
// step), so that at U = N ~94% of the output is zero rows past seg[n - 1].
//
// What bounds it: bytes. It reads g and seg once and writes (U, W), one
// add per float: 97.8 MB (29.2 us at 3.35 TB/s) for the adagrad_row pack
// at N = 638,976, 171.2 MB (51.1 us) for the direct step's terms at U = N
// = 638,976, 79 MB of it zero rows. Two layouts, chosen by the caller
// from W (ops/segsum.py::rowsum_layout):
//
// * W <= 64, every width a path gives B5: B6's staged tiles without the
//   squares (rowsum_tiles_kernel<false>, below, with B6's note): a block
//   stages a chunk of consecutive rows by one bulk copy and sums it in
//   row groups of W threads, so device-memory reads are whole lines
//   whatever W is; it writes the zero rows in pass 1 (the tail past
//   seg[n - 1] a slice a block, by 16-byte stores, after its sums), and
//   pass 2 sums only the partial rows of crossing runs.
// * Wider rows: rowsum_chunks_kernel, below. Lanes own columns (lane l
//   owns columns col0 + l, col0 + l + 32, ... of a tile of 32 * C
//   columns), so a warp reads each row of its tile with coalesced 128-byte
//   loads, G rows ahead; wider rows take more tiles, one per blockIdx.y,
//   so any W up to 65,536 works. Fixed chunks of kChunk slots, one warp
//   each, two partial rows per chunk, and pass 2 with `zeros`, which also
//   writes the zero rows.
//
// Measured on the H100 (PERF.md, kernel_times.py): on the tiles W = 35
// over the ladder plan takes 54.8 us (53% of the bound; the chunked
// kernel 61.1), W = 33 at U = N 79.5 us (64%; chunked 110.4, which left
// its 79 MB of zero rows to pass 2, 54 us of it), W = 17 at U = N 32.9 us
// (41%; chunked 57.5, index_add_ 47). What holds the tiles: pass 1 moves
// 2.2 to 2.5 TB/s, as B6's, and pass 2 costs 5 to 9 us of dependent
// round trips at every shape. At config 1's N = 8,192 (W = 9) the two
// launches' latency is all there is: 11.5 us against the chunked
// kernel's 32.8, but index_add_ (3.6 us) and the plain version (8.9) are
// faster there. On the ladder plan the tiles win at W = 9 to 35 and 177,
// the chunked kernel at W = 66 (86.6 against 88.2 us) and 354 (418
// against 434): no path runs B5 past W = 35, so the rule keeps one
// threshold between 35 and 66. At narrow rows the chunked layout loses
// as B6's note says: at W = 33 a warp's second column tile has one busy
// lane and every 132-byte row is two scattered requests. Tried and no
// faster on the tiles: other chunk sizes (1 to 16 chunks an SM at least,
// 32 KB tiles), and the tail's zero rows written while the copy lands
// (1-2% slower at U = N than after the sums).
//
// seg must be sorted, gaps allowed; a rank outside [0, num_segments)
// traps. No atomics on either layout: the sums repeat bit for bit.

constexpr int64_t kMaxRowWidth = 1 << 16;

// C columns per lane (a tile of 32 * C), G rows loaded ahead per step.
template <int C, int G>
__global__ void __launch_bounds__(kThreads1)
rowsum_chunks_kernel(const float* __restrict__ g,       // (N, w)
                     const int32_t* __restrict__ seg,   // (N,) sorted
                     float* __restrict__ out,           // (U, w)
                     float* __restrict__ partials,      // (chunks, 2, w)
                     int64_t n, int64_t num_segments, int64_t w,
                     int64_t num_chunks) {
  const int lane = threadIdx.x & 31;
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
    float acc[C];
#pragma unroll
    for (int q = 0; q < C; ++q) acc[q] = 0.f;

    // Writes the sums of the run `rank` to out[rank], or to this chunk's
    // partial row 0 (the run began in an earlier chunk) or 1 (it goes on
    // into the next chunk).
    auto flush = [&](bool last) {
      const bool head = first_run && before == rank;
      const bool tail = last && after == rank;
      float* dst = head   ? partials + (2 * c) * w
                   : tail ? partials + (2 * c + 1) * w
                          : out + static_cast<int64_t>(rank) * w;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int64_t col = col0 + lane + 32 * q;
        if (col < w) dst[col] = acc[q];
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
          for (int q = 0; q < C; ++q) acc[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < C; ++q) acc[q] += v[t][q];
      }
    }
    if (rank >= 0) flush(true);
  }
}

template <int C, int G>
void launch_chunks(const float* g, const int32_t* seg, float* out,
                   float* partials, int64_t n, int64_t num_segments, int64_t w,
                   int64_t num_chunks, dim3 grid, cudaStream_t stream) {
  rowsum_chunks_kernel<C, G><<<grid, kThreads1, 0, stream>>>(
      g, seg, out, partials, n, num_segments, w, num_chunks);
}

// Both passes of B5 on the chunked layout; returns cudaGetLastError().
int launch_rowsum_chunked(const float* g, const int32_t* seg, float* out,
                          float* partials, int64_t n, int64_t num_segments,
                          int64_t w, int num_sms, void* stream) {
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
      launch_chunks<1, 32>(g, seg, out, partials, n, num_segments, w,
                           num_chunks, grid, s);
      break;
    case 2:
      launch_chunks<2, 16>(g, seg, out, partials, n, num_segments, w,
                           num_chunks, grid, s);
      break;
    case 3:
      launch_chunks<3, 8>(g, seg, out, partials, n, num_segments, w,
                          num_chunks, grid, s);
      break;
    default:
      launch_chunks<4, 8>(g, seg, out, partials, n, num_segments, w,
                          num_chunks, grid, s);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_crossing(seg, partials, out, n, num_segments, w, kChunk,
                  num_chunks, num_sms, true, s);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// B6, redesigned: segment_rowsum_sq by staged tiles (rowsum_tiles_kernel
// with the squares, then rows_crossing_kernel).
//
//   out[r] = [ sum g[i] | sum g[i]^2 ]  over the slots i with seg[i] == r
//                                                                  (U, 2W)
//
// Replaces the TPU kernel sparkfm_tpu/ops/pallas_segsum.py::
// _segsum_sq_kernel (called through _segment_rowsum_sq_pallas, public
// segment_rowsum_sq), which no path of the JAX package runs on the TPU;
// there the packs [g | g^2] are built in memory and summed by B5. Its
// callers in the port: the direct and dedup steps' [v | w] gradients
// (sparkfm_tpu_torch/ops/embedding.py::accumulate_sq_to_unique_sorted,
// W = k + 1: 9 at BASELINE config 1, 33 at config 3's width) and, under
// adagrad and sgd, the fused and sorted steps' [g_v | g_w] (W = vk + 1:
// 33 at config 3, 177 for config 4's FFM record), so that the pack
// [g_v | g_v^2 | g_w | g_w^2] never exists in memory.
//
// What bounds it: bytes. It reads g (N W floats) and seg once and writes
// (U, 2W): 97.7 MB at the dedup and fused payload (N = 638,976, W = 33,
// U = 40,960), a 29 us floor at 3.35 TB/s, against three float operations
// per element. B5's chunked layout (lanes over columns, 256-slot chunks a
// warp) loses at the shapes B6 is given: at W = 33 a warp's
// second column tile has one busy lane and every 132-byte row is two
// scattered requests; at W = 177 the second tile has 49 busy lanes of
// 128 and re-reads seg; at N = 8,192 (config 1) 32 chunks give 32 warps
// to 132 SMs. So:
//
// * A chunk is `chunk` consecutive sorted slots, one block each. Its rows
//   are one contiguous span of g, which thread 0 stages into shared memory
//   with one bulk copy (bulk_copy.cuh) of the span rounded out to 16-byte
//   bounds, kept at its offset below the bound so the copy lands aligned
//   (the first and last chunks, whose rounded copy could leave g, are
//   loaded by the threads). The threads load the chunk's ranks meanwhile.
//   Device-memory reads are whole lines whatever W is; three blocks an SM
//   keep copies in flight while one reduces.
// * The block's threads are `groups` row groups of min(W, kTileThreads)
//   columns: thread (j, c) sums column c (and, for W > kTileThreads,
//   c + kTileThreads, ...) over group j's `per` = chunk / groups rows, in
//   slot order, from shared memory, and writes a run that begins and ends
//   inside its rows straight to out[r]. So at W = 33 15 groups keep 495 of
//   a block's 512 threads busy, at W = 9 56 groups 504.
// * A run that crosses a group boundary leaves the group's first run
//   (begun in an earlier group) and last run (going on) in shared memory;
//   after one barrier, the thread of the group where such a run begins
//   adds the later groups' parts in group order, and writes the run to
//   out[r], or, when it goes on past the chunk, to the chunk's partial row
//   1. Group 0's thread does the same for the chunk's first run when it
//   began in an earlier chunk: partial row 0. With one group (wide rows)
//   the group's first and last runs are the chunk's partial rows directly.
// * The chunk size falls with N: the rows that fit in 64 KB of shared
//   memory with their ranks, at most N over 4 chunks an SM, a multiple of
//   `groups` (the caller's choice, ops/segsum.py::tile_layout), so
//   config 1's 8,192 slots spread over 512 blocks.
// * Pass 1 also writes the zero rows of the ranks no slot has (those
//   between a slot's rank and the slot before's, found as the ranks are
//   loaded and written a warp a gap while the copy lands, and a slice a
//   block of those past the last slot's), so pass 2 (rows_crossing_kernel,
//   above, called without `zeros`) only sums the partial rows of crossing
//   runs. Left to pass 2, the zeros cost ~1.1 us at config 1's shape and
//   ~2.5 us at W = 33 and 177 (PERF.md).
//
// Measured on the H100 (PERF.md): pass 1 moves ~2.3 TB/s, so at the dedup
// and fused payload B6 takes ~52 us, ~56% of its bound. Tried and slower:
// a persistent block a few chunks long with two stages (its prefetch one
// chunk ahead left each block one copy's latency per chunk), the copy cut
// into 16 or 32 bulk copies, and tiles of 32, 44 or 96 KB at W = 33.
//
// The order of the f32 sums, fixed: a run's slots in order within a group
// (the squares each one fused multiply-add), then its groups' parts in
// group order, then its chunks' partial rows in pass 2's order. No
// atomics: the sums repeat bit for bit. seg must be sorted; gaps are
// allowed; a rank outside [0, num_segments) traps the kernel where the
// chunk's ranks are loaded, before its block writes a row (other blocks
// may have written theirs).
//
// B5's rows of up to 64 floats run on this kernel without the squares
// (kSquares false): the same design and summation order, sums only, the
// partial rows and the output W wide (B5's note, above).

constexpr int kTileThreads = 512;       // pass 1: most threads a block
constexpr int kTileBlocks = 3;          // pass 1: blocks an SM (launch bound)
constexpr size_t kTileMaxSmem = 200 * 1024;  // pass 1: a chunk's rows, ranks

// Zeros out[f0, f1) (out 16-byte aligned), block b of `blocks` its slice
// of whole 16-byte stores, its `nt` threads over consecutive ones; the at
// most three floats at each end of the range by block b = 0.
__device__ __forceinline__ void zero_range(float* __restrict__ out,
                                           int64_t f0, int64_t f1, int64_t b,
                                           int64_t blocks, int t, int nt) {
  if (f1 <= f0) return;
  int64_t a0 = (f0 + 3) & ~int64_t{3};
  int64_t a1 = f1 & ~int64_t{3};
  if (a1 < a0) a0 = a1 = f1;            // inside one 16 bytes: floats only
  if (b == 0) {
    if (t < a0 - f0) out[f0 + t] = 0.f;
    if (t < f1 - a1) out[a1 + t] = 0.f;
  }
  const int64_t q0 = a0 >> 2, q1 = a1 >> 2;
  const int64_t per = (q1 - q0 + blocks - 1) / blocks;
  const int64_t s = q0 + b * per;
  const int64_t e = s + per < q1 ? s + per : q1;
  float4* const out4 = reinterpret_cast<float4*>(out);
  for (int64_t q = s + t; q < e; q += nt)
    out4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Pass 1 of B6 (kSquares: out[r] = [sum g | sum g^2], 2w wide) and of B5
// on tiles (sums only, w wide): block c sums chunk c, `chunk` slots in
// `groups` row groups of `per` rows and `cols` = min(w, kTileThreads)
// columns. The chunk's span of g starts `ph` floats past a 16-byte bound;
// the tile keeps it at that offset, so the span rounded out to 16-byte
// bounds is one aligned bulk copy. A chunk whose rounded copy would leave
// g (the first and last ones) is loaded by the threads instead.
template <bool kSquares>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
rowsum_tiles_kernel(const float* __restrict__ g,     // (N, w)
                    const int32_t* __restrict__ seg, // (N,) sorted
                    float* __restrict__ out,         // (U, out_w)
                    float* __restrict__ partials,    // (chunks, 2, out_w)
                    int64_t n, int64_t num_segments, int w, int chunk,
                    int groups, int per, int cols, int tile_floats) {
  constexpr int kParts = kSquares ? 2 : 1;   // sums, and their squares'
  extern __shared__ __align__(16) float tile_smem[];  // rows, then ranks
  // the groups' first runs begun before them (parts 0 .. kParts - 1) and
  // last runs going on after them (parts kParts ..), at [group * w +
  // column]
  __shared__ float ends[2 * kParts][kTileThreads];
  __shared__ __align__(8) uint64_t bar;
  const int t = threadIdx.x;
  const int64_t out_w = kParts * static_cast<int64_t>(w);
  const int64_t c0 = blockIdx.x;
  const int64_t s0 = c0 * chunk;
  const int rows = static_cast<int>(n - s0 < chunk ? n - s0 : chunk);
  const int32_t last_rank = seg[n - 1];   // for the zero rows past it

  // tile[i] = g[s0 w + i]; ranks[i] = seg[s0 - 1 + i], -1 past the ends
  const float* const src = g + s0 * w;
  const int ph = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2 & 3);
  float* const tile = tile_smem + ph;
  int32_t* const ranks = reinterpret_cast<int32_t*>(tile_smem + tile_floats);
  const bool by_copy = s0 * w >= 4 && (s0 + rows) * w + 4 <= n * w;
  if (t == 0 && by_copy) {
    const uint32_t bytes = (ph + rows * w + 3) / 4 * 16;
    sfm::mbar_init(&bar, 1);
    sfm::mbar_init_fence();
    sfm::mbar_expect_bytes(&bar, bytes);
    sfm::bulk_load(tile_smem, src - ph, bytes, &bar);
  }
  if (!by_copy)
    for (int i = t; i < rows * w; i += blockDim.x) tile[i] = src[i];
  // the ranks, checked before any is used, and whether the chunk has a
  // gap: a slot whose rank is more than one past the slot before's
  bool gap = false;
  for (int i = t; i < rows + 2; i += blockDim.x) {
    const int64_t s = s0 - 1 + i;
    int32_t r = -1;
    if (s >= 0 && s < n) {
      r = seg[s];
      if (r < 0 || static_cast<int64_t>(r) >= num_segments) __trap();
      if (i > 0 && i <= rows) gap |= r > (s > 0 ? seg[s - 1] : -1) + 1;
    }
    ranks[i] = r;
  }
  // while the copy lands, in a chunk with gaps (the plans' ranks have
  // none): the zero rows of the ranks between each slot's and the slot
  // before's (ranks[0] is -1 for the first chunk), a warp a slot, its
  // lanes over the gap's floats, which are contiguous in out
  if (__syncthreads_or(gap)) {
    for (int i = 1 + (t >> 5); i <= rows; i += blockDim.x >> 5) {
      const int64_t f1 = static_cast<int64_t>(ranks[i]) * out_w;
      for (int64_t f = (ranks[i - 1] + 1) * out_w + (t & 31); f < f1;
           f += 32)
        out[f] = 0.f;
    }
  }
  if (by_copy) sfm::mbar_wait(&bar, 0);

  const int j = t / cols;                 // row group
  const int cp = t - j * cols;            // column
  const int r0 = j * per;
  const int r1 = r0 + per < rows ? r0 + per : rows;
  if (j < groups && r0 < r1) {
    const int32_t before = ranks[r0];
    const int32_t after = ranks[r1 + 1];
    for (int c = cp; c < w; c += cols) {
      int32_t rank = ranks[r0 + 1];
      bool first = true;
      float acc = 0.f, sq = 0.f;
      // the run `rank`'s sums: to out[rank], or, for the group's first run
      // begun before it or its last run going on, to shared memory (or,
      // with one group, the chunk's partial row 0 or 1)
      auto flush = [&](bool last) {
        const bool begun = first && rank == before;
        const bool going = last && rank == after;
        if (groups > 1 && (begun || going)) {
          const int e = begun ? 0 : kParts;
          ends[e][j * w + c] = acc;
          if constexpr (kSquares) ends[e + 1][j * w + c] = sq;
          return;
        }
        float* const dst = begun   ? partials + 2 * c0 * out_w
                           : going ? partials + (2 * c0 + 1) * out_w
                                   : out + static_cast<int64_t>(rank) * out_w;
        dst[c] = acc;
        if constexpr (kSquares) dst[w + c] = sq;
      };
      const float* v = tile + r0 * w + c;
#pragma unroll 4
      for (int i = r0; i < r1; ++i, v += w) {
        const int32_t r = ranks[i + 1];
        if (r != rank) {
          flush(false);
          first = false;
          rank = r;
          acc = sq = 0.f;
        }
        acc += *v;
        if constexpr (kSquares) sq = fmaf(*v, *v, sq);
      }
      flush(true);
    }
  }
  if (groups > 1) {                       // block-uniform
    // runs that cross group boundaries, each by the thread of the group
    // where it begins (w <= kTileThreads / 2 here, so c = cp); group m's
    // first rank is ranks[m per + 1], its last ranks[end_of(m)]
    __syncthreads();
    const int active = (rows + per - 1) / per;   // groups with rows
    auto end_of = [&](int m) {
      return m * per + per < rows ? m * per + per : rows;
    };
    auto begun = [&](int m) { return ranks[m * per + 1] == ranks[m * per]; };
    auto going = [&](int m) {
      return ranks[end_of(m)] == ranks[end_of(m) + 1];
    };
    auto one_run = [&](int m) {
      return ranks[m * per + 1] == ranks[end_of(m)];
    };
    auto passes_through = [&](int m) {   // one run, begun before, going on
      return begun(m) && one_run(m) && going(m);
    };
    const int c = cp;
    if (j < active && going(j) && !(begun(j) && one_run(j))) {
      float acc = ends[kParts][j * w + c], sq = 0.f;
      if constexpr (kSquares) sq = ends[kParts + 1][j * w + c];
      float* dst = out + static_cast<int64_t>(ranks[end_of(j)]) * out_w;
      for (int m = j + 1;; ++m) {
        if (m >= active) {                // it goes on past the chunk
          dst = partials + (2 * c0 + 1) * out_w;
          break;
        }
        acc += ends[0][m * w + c];
        if constexpr (kSquares) sq += ends[1][m * w + c];
        if (!passes_through(m)) break;
      }
      dst[c] = acc;
      if constexpr (kSquares) dst[w + c] = sq;
    }
    if (j == 0 && begun(0)) {             // the chunk's first run
      float acc = ends[0][c], sq = 0.f;
      if constexpr (kSquares) sq = ends[1][c];
      for (int m = 0; passes_through(m) && m + 1 < active; ++m) {
        acc += ends[0][(m + 1) * w + c];
        if constexpr (kSquares) sq += ends[1][(m + 1) * w + c];
      }
      float* const dst = partials + 2 * c0 * out_w;
      dst[c] = acc;
      if constexpr (kSquares) dst[w + c] = sq;
    }
  }
  // the zero rows of the ranks past the last slot's, a slice a block
  zero_range(out, (static_cast<int64_t>(last_rank) + 1) * out_w,
             num_segments * out_w, c0, gridDim.x, t, blockDim.x);
}

// Both passes of B6 (kSquares) or of B5 on tiles; returns
// cudaGetLastError().
template <bool kSquares>
int launch_rowsum_tiles(const float* g, const int32_t* seg, float* out,
                        float* partials, int64_t n, int64_t num_segments,
                        int64_t w, int64_t chunk, int64_t groups, int num_sms,
                        void* stream) {
  if (n <= 0) return 0;
  const int64_t cols = w < kTileThreads ? w : kTileThreads;
  if (w < 1 || chunk < 1 || groups < 1 || groups > chunk ||
      groups * cols > kTileThreads ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the chunk's span rounded out to 16-byte bounds, then its ranks
  const int64_t tile_floats = (chunk * w + 6 + 3) / 4 * 4;
  const size_t smem = 4 * static_cast<size_t>(tile_floats + chunk + 2);
  if (smem > kTileMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // past 48 KB with the static arrays, a block's shared memory needs the
  // opt-in, set once a device (and kernel) to the most any launch asks
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(rowsum_tiles_kernel<kSquares>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kTileMaxSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t num_chunks = (n + chunk - 1) / chunk;
  rowsum_tiles_kernel<kSquares><<<static_cast<unsigned>(num_chunks),
                                  static_cast<int>((groups * cols + 31) / 32
                                                   * 32),
                                  smem, s>>>(
      g, seg, out, partials, n, num_segments, static_cast<int>(w),
      static_cast<int>(chunk), static_cast<int>(groups),
      static_cast<int>((chunk + groups - 1) / groups),
      static_cast<int>(cols), static_cast<int>(tile_floats));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_crossing(seg, partials, out, n, num_segments, (kSquares ? 2 : 1) * w,
                  chunk, num_chunks, num_sms, false, s);
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

// ---------------------------------------------------------------------------
// The ALS stream sums (als_stream_sums_kernel, then
// als_stream_sums_crossing_kernel): B7 at S = 5 over the five product
// streams of a (factor, block) of the compact ALS sweep
// (sparkfm_tpu_torch/solvers/als.py), formed inside the kernel,
//
//   out[r] = sum over the slots i of run r of
//            [e_c x q_c, e_c x^2, x^2 q_c^2, x^3 q_c, x^4],
//   (e_c, q_c) = eq[row[i]]  (eq[i] when row is null),
//
// with x, row and seg the block's slice of the CSC view and eq the (N, 2)
// array that holds each example's residual e and the factor's sum q side
// by side. It stands beside the TPU kernel
// sparkfm_tpu/ops/pallas_segsum.py::_segsum_streams_kernel (B7), whose
// function it extends: the JAX package gathers e and q and forms the
// streams in XLA, then sums them with B7. 64 calls a sweep of BASELINE
// config 2 (K = 32, two blocks).
//
// What bounds it: bytes. Without rows (block 0, whose CSC order is the
// example order) it reads seg, x and eq once: 16 bytes a slot, 400 MB at
// N = 25M, a 121 us floor at 3.35 TB/s. With rows it reads seg, x and the
// rows (12 bytes a slot) and eq[row], which on the movie block lands on
// scattered examples: one 32-byte sector a slot, most of them from DRAM,
// since eq holds 200 MB against a 50 MB L2. Interleaving e and q is what
// makes it one sector: as two arrays of 4 bytes they cost two sectors a
// slot. The torch passes it replaces wrote and read back the two gathered
// arrays and the five streams, 56 bytes a slot more, in 11 launches. The
// design is B7's (above), with these changes:
//
// * What a tile stages: seg, x and the rows (or eq, two floats a slot, in
//   two strides of a buffer) by bulk copies, as B7 stages its streams. A
//   lane then loads eq[row] of its V = 16 slots from device memory, 16
//   loads of 8 bytes all issued before the first is used, and forms the
//   products in registers. Staged pairs are read by rotated 16-byte loads
//   (staged_pairs): a lane's pairs span 128 bytes, and straight loads
//   met eight-way bank conflicts that cost the user block 8-12%.
// * Numerics: each product is formed as torch forms its stream, (e x) q,
//   e (x x), ((x x) q) q, ((x x) x) q, (x x)(x x), by __fmul_rn, which the
//   compiler does not contract into the sum's add, and summed in B7's
//   order (B7's pass 1 and pass 2 bodies, chunk_sums and crossing_sums,
//   are shared), so the sums equal B7's over the torch-formed streams bit
//   for bit.
// * Tiles of one step (512 slots): small buffers leave room for more
//   warps an SM, which the gathers need.
//
// What holds it, measured on the H100 (PERF.md): at config 2's shapes the
// user block takes ~162 us (74% of its floor), as with e and q apart,
// against ~1.08 ms for the streams and B7; the movie block ~0.81 ms
// (1.49 ms with e and q apart) against ~2.50 ms for the gathers, streams
// and B7. Its 25M gathers of 8 bytes run at ~31G a second: the scattered
// sectors of eq still set that block's time. Half as many loads a lane
// keep enough in flight: forcing more warps an SM by launch bounds (16,
// 24 blocks) made it spill and run 1.7-2.6x longer.
//
// No kernel of it has "colsums" in its name, so that a trace's B7 time
// stays B7's. A row outside [0, rows) traps, as a rank outside [0, U)
// does.

constexpr int64_t kColChunk = 4096;    // sorted slots per pass-1 block
constexpr int kColPad = 4;             // floats a shifted bulk copy adds
constexpr uint32_t kColSmem = 40 * 1024;  // pass 1's two buffers
constexpr int kMaxStreams = 16;
constexpr int kColThreads2 = 256;      // pass 2: a warp per chunk
constexpr int kColWarps2 = kColThreads2 / 32;
constexpr int kProducts = 5;           // the ALS stream sums' columns

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

// V floats of a lane's slots from a staged array, `sh` floats past the
// 16-byte boundary its copy starts at: 16-byte loads when that is 0.
template <int V>
__device__ __forceinline__ void staged(const float* src, int sh,
                                       float (&x)[V]) {
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
}

// What pass 1 stages and sums for B7: seg (array 0) and s <= SM streams,
// each slot's values the streams' own. from_smem reads a lane's V slots of
// a staged tile (array a at buf + a * stride, shift(a) floats in), and
// from_global the first lc of them from device memory.
template <int SM>
struct StreamSlots {
  static constexpr int kArrays = SM + 1;  // the most arrays it stages
  Streams streams;
  const int32_t* seg;
  int s;

  __device__ __forceinline__ int width() const { return s; }
  __device__ __forceinline__ int arrays() const { return s + 1; }
  __device__ __forceinline__ int span() const { return s + 1; }
  __device__ __forceinline__ int floats(int) const { return 1; }
  __device__ __forceinline__ const float* array(int a) const {
    return a == 0 ? reinterpret_cast<const float*>(seg) : streams.p[a - 1];
  }
  template <int V, class Shift>
  __device__ __forceinline__ void from_smem(const float* buf, int stride,
                                            int off, Shift shift,
                                            int32_t (&r)[V],
                                            float (&v)[V][SM]) const {
#pragma unroll
    for (int a = 0; a <= SM; ++a) {
      if (a > s) continue;
      const int sh = shift(a);
      float x[V];
      staged<V>(buf + a * stride + sh + off, sh, x);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (a == 0) r[i] = __float_as_int(x[i]);
        else v[i][a > 0 ? a - 1 : 0] = x[i];
      }
    }
  }
  template <int V>
  __device__ __forceinline__ void from_global(int64_t slot0, int lc,
                                              int32_t (&r)[V],
                                              float (&v)[V][SM]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < lc) {
        const int64_t slot = slot0 + i;
        r[i] = seg[slot];
#pragma unroll
        for (int q = 0; q < SM; ++q)
          if (q < s) v[i][q] = streams.p[q][slot];
      }
    }
  }
};

// V slots' (e, q) pairs of a lane from a staged (N, 2) array, `sh` floats
// past the 16-byte boundary its copy starts at (0 or 2: the array is
// 8-byte aligned). When that is 0, 16-byte loads of two slots each, lane
// L's k-th load taking its chunk (k + L) % (V / 2): a lane's V pairs span
// 128 bytes, so the lanes of a quarter warp reading the same chunk would
// fall on the same four banks, eight ways over; rotated, they fall on
// distinct banks, and a rotation by L % (V / 2) in registers (three
// stages of selects) puts the chunks back in slot order. Without it the
// user block ran 8-12% longer than with e and q as two arrays of 4 bytes
// (PERF.md).
template <int V>
__device__ __forceinline__ void staged_pairs(const float* src, int sh,
                                             float (&a)[V], float (&b)[V]) {
  if (sh == 0) {
    constexpr int C = V / 2;
    const int r = threadIdx.x & (C - 1);
    float4 c[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
      c[k] = *reinterpret_cast<const float4*>(src + 4 * ((k + r) & (C - 1)));
#pragma unroll
    for (int bit = 1; bit < C; bit <<= 1) {
      const bool on = (r & bit) != 0;
      float4 t[C];
#pragma unroll
      for (int j = 0; j < C; ++j) t[j] = c[(j - bit) & (C - 1)];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        c[j].x = on ? t[j].x : c[j].x;
        c[j].y = on ? t[j].y : c[j].y;
        c[j].z = on ? t[j].z : c[j].z;
        c[j].w = on ? t[j].w : c[j].w;
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      a[2 * j] = c[j].x; b[2 * j] = c[j].y;
      a[2 * j + 1] = c[j].z; b[2 * j + 1] = c[j].w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float2 f = *reinterpret_cast<const float2*>(src + 2 * i);
      a[i] = f.x; b[i] = f.y;
    }
  }
}

// What pass 1 stages and sums for the ALS stream sums: seg, x and, with
// kGather, the rows (each slot's (e, q) pair is then gathered from device
// memory by one 8-byte load, every lane's loads in flight at once), else
// the pairs themselves (array 2, two floats a slot, two strides of a
// buffer); each slot's five products formed in registers in the order
// torch forms the streams, by round-to-nearest multiplies that the
// compiler may not contract into a sum's add.
template <bool kGather>
struct ProductSlots {
  static constexpr int kArrays = 3;
  static constexpr int kSpan = kGather ? 3 : 4;  // strides a buffer holds
  const int32_t* seg;
  const float* x;
  const int32_t* row;
  const float2* eq;                     // (num_rows,): e, q
  uint32_t num_rows;

  __device__ __forceinline__ int width() const { return kProducts; }
  __device__ __forceinline__ int arrays() const { return kArrays; }
  __device__ __forceinline__ int span() const { return kSpan; }
  __device__ __forceinline__ int floats(int a) const {
    return !kGather && a == 2 ? 2 : 1;
  }
  __device__ __forceinline__ const float* array(int a) const {
    return a == 0 ? reinterpret_cast<const float*>(seg)
           : a == 1 ? x
           : kGather ? reinterpret_cast<const float*>(row)
           : reinterpret_cast<const float*>(eq);
  }
  // eq[row] of the first lc slots
  template <int V>
  __device__ __forceinline__ void gather(const float (&rw)[V], int lc,
                                         float (&ev)[V],
                                         float (&qv)[V]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < lc) {
        const uint32_t j = __float_as_uint(rw[i]);
        if (j >= num_rows) __trap();
        const float2 p = __ldg(eq + j);
        ev[i] = p.x;
        qv[i] = p.y;
      }
    }
  }
  template <int V>
  __device__ __forceinline__ void products(const float (&sg)[V],
                                           const float (&xv)[V],
                                           const float (&ev)[V],
                                           const float (&qv)[V], int lc,
                                           int32_t (&r)[V],
                                           float (&v)[V][kProducts]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < lc) {
        r[i] = __float_as_int(sg[i]);
        const float x1 = xv[i], e1 = ev[i], q1 = qv[i];
        const float x2 = __fmul_rn(x1, x1);
        v[i][0] = __fmul_rn(__fmul_rn(e1, x1), q1);   // (e x) q
        v[i][1] = __fmul_rn(e1, x2);                   // e x^2
        v[i][2] = __fmul_rn(__fmul_rn(x2, q1), q1);   // (x^2 q) q
        v[i][3] = __fmul_rn(__fmul_rn(x2, x1), q1);   // (x^2 x) q
        v[i][4] = __fmul_rn(x2, x2);                   // x^2 x^2
      }
    }
  }
  template <int V, class Shift>
  __device__ __forceinline__ void from_smem(const float* buf, int stride,
                                            int off, Shift shift,
                                            int32_t (&r)[V],
                                            float (&v)[V][kProducts]) const {
    float sg[V], xv[V], ev[V], qv[V];
    staged<V>(buf + shift(0) + off, shift(0), sg);
    staged<V>(buf + stride + shift(1) + off, shift(1), xv);
    if (kGather) {
      float rw[V];
      staged<V>(buf + 2 * stride + shift(2) + off, shift(2), rw);
      gather<V>(rw, V, ev, qv);
    } else {
      staged_pairs<V>(buf + 2 * stride + shift(2) + 2 * off, shift(2), ev,
                      qv);
    }
    products<V>(sg, xv, ev, qv, V, r, v);
  }
  template <int V>
  __device__ __forceinline__ void from_global(int64_t slot0, int lc,
                                              int32_t (&r)[V],
                                              float (&v)[V][kProducts]) const {
    float sg[V], xv[V], ev[V], qv[V], rw[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < lc) {
        sg[i] = __int_as_float(seg[slot0 + i]);
        xv[i] = x[slot0 + i];
        if (kGather) {
          rw[i] = __int_as_float(row[slot0 + i]);
        } else {
          const float2 p = eq[slot0 + i];
          ev[i] = p.x;
          qv[i] = p.y;
        }
      }
    }
    if (kGather) gather<V>(rw, lc, ev, qv);
    products<V>(sg, xv, ev, qv, lc, r, v);
  }
};

// Pass 1 of B7 and of the ALS stream sums: the sums of chunk blockIdx.x's
// slots, as `slots` gives them (SM: the values a slot holds; V: its slots
// a lane), in B7's order (the design note above). The dynamic shared
// memory holds two buffers of the slots' staged arrays, each span()
// strides of tile + kColPad floats: an array of floats(a) floats a slot
// takes that many strides (only the last array may take two).
template <int SM, int V, class Slots>
__device__ __forceinline__ void chunk_sums(const Slots& slots,
                                           const int32_t* __restrict__ seg,
                                           float* __restrict__ out,
                                           float* __restrict__ partials,
                                           int64_t n, int64_t num_segments,
                                           int tile) {
  extern __shared__ __align__(16) float smem[];  // [2][arrays][tile + pad]
  __shared__ __align__(8) uint64_t bar[2];
  constexpr int A = Slots::kArrays;
  const int s = slots.width();
  const int arrays = slots.arrays();
  const int span = slots.span();
  const int lane = threadIdx.x;
  const int64_t c = blockIdx.x;
  const int64_t s0 = c * kColChunk;
  const int64_t s1 = s0 + kColChunk < n ? s0 + kColChunk : n;
  const int32_t before = s0 > 0 ? seg[s0 - 1] : -1;
  const int32_t after = s1 < n ? seg[s1] : -1;
  const int stride = tile + kColPad;
  // floats from the 16-byte boundary below an array's tile start to it;
  // tiles start at multiples of 4 slots, so the same for every tile and
  // array width
  auto shift = [&](int a) -> int {
    return static_cast<int>(
        reinterpret_cast<uintptr_t>(slots.array(a)) >> 2 & 3);
  };
  // a tile read by bulk copies: the shifted copy stays inside [0, N)
  auto in_smem = [&](int64_t i0) {
    return i0 >= kColPad && i0 + tile + kColPad <= n;
  };
  // lane 0 starts the copies of the tile at slot i0 into buffer b
  auto load = [&](int64_t i0, int b) {
    uint32_t bytes = 0;
#pragma unroll
    for (int a = 0; a < A; ++a)
      if (a < arrays)
        bytes += (slots.floats(a) * tile + (shift(a) ? kColPad : 0)) * 4;
    sfm::mbar_expect_bytes(&bar[b], bytes);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (a < arrays) {
        const int sh = shift(a);
        const int w = slots.floats(a);
        sfm::bulk_load(smem + (b * span + a) * stride,
                       slots.array(a) + w * i0 - sh,
                       (w * tile + (sh ? kColPad : 0)) * 4, &bar[b]);
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
    const float* buf = smem + b * span * stride;
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
      if (from_smem)                        // full tile: lc == V
        slots.template from_smem<V>(buf, stride, off, shift, r, v);
      else
        slots.template from_global<V>(i0 + off, lc, r, v);
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

// B7's pass 1. SM: s rounded up (1, 2, 4, 5, 8 or 16), the streams held
// per lane; V: consecutive slots per lane, a multiple of 4.
template <int SM, int V>
__global__ void __launch_bounds__(32)
colsums_chunks_kernel(Streams streams, int s,
                      const int32_t* __restrict__ seg,   // (N,) sorted
                      float* __restrict__ out,           // (U, s)
                      float* __restrict__ partials,      // (chunks, 2, s)
                      int64_t n, int64_t num_segments, int tile) {
  chunk_sums<SM, V>(StreamSlots<SM>{streams, seg, s}, seg, out, partials,
                    n, num_segments, tile);
}

// The ALS stream sums' pass 1: B7's at S = 5, V = 16, on products formed
// from the (e, q) pairs (gathered by `row` when kGather) and x.
template <bool kGather>
__global__ void __launch_bounds__(32)
als_stream_sums_kernel(const float2* __restrict__ eq,   // (rows,): e, q
                       const float* __restrict__ x,     // (N,)
                       const int32_t* __restrict__ row, // (N,) or null
                       const int32_t* __restrict__ seg, // (N,) sorted
                       float* __restrict__ out,         // (U, 5)
                       float* __restrict__ partials,    // (chunks, 2, 5)
                       int64_t n, int64_t num_rows, int64_t num_segments,
                       int tile) {
  chunk_sums<kProducts, 16>(
      ProductSlots<kGather>{seg, x, row, eq,
                            static_cast<uint32_t>(num_rows)},
      seg, out, partials, n, num_segments, tile);
}

// Row j of the partial rows of the run that begins in chunk c: chunk c's
// row 1, then row 0 of chunk c + j.
__device__ __forceinline__ const float* colsums_partial(
    const float* partials, int64_t c, int64_t j, int s) {
  return partials + (j == 0 ? 2 * c + 1 : 2 * (c + j)) * s;
}

// Pass 2 of B7 and of the ALS stream sums: block g takes chunks 8g ..
// 8g + 7, one warp each.
__device__ __forceinline__ void crossing_sums(
    const int32_t* __restrict__ seg, const float* __restrict__ partials,
    float* __restrict__ out, int64_t n, int s, int64_t num_chunks) {
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

__global__ void __launch_bounds__(kColThreads2)
colsums_crossing_kernel(const int32_t* __restrict__ seg,
                        const float* __restrict__ partials,
                        float* __restrict__ out, int64_t n, int s,
                        int64_t num_chunks) {
  crossing_sums(seg, partials, out, n, s, num_chunks);
}

__global__ void __launch_bounds__(kColThreads2)
als_stream_sums_crossing_kernel(const int32_t* __restrict__ seg,
                                const float* __restrict__ partials,
                                float* __restrict__ out, int64_t n,
                                int64_t num_chunks) {
  crossing_sums(seg, partials, out, n, kProducts, num_chunks);
}

// Pass 2's grid: a block per 8 chunks, at most 8 blocks an SM.
unsigned crossing_blocks(int64_t num_chunks, int num_sms) {
  int64_t blocks = (num_chunks + kColWarps2 - 1) / kColWarps2;
  const int64_t cap = static_cast<int64_t>(num_sms) * (2048 / kColThreads2);
  return static_cast<unsigned>(blocks > cap ? cap : blocks);
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

template <bool kGather>
void launch_als_stream_sums(const float2* eq, const float* x,
                            const int32_t* row, const int32_t* seg,
                            float* out, float* partials, int64_t n,
                            int64_t num_rows, int64_t num_segments,
                            int64_t num_chunks, cudaStream_t stream) {
  // one step a tile: small buffers leave room for more warps an SM, which
  // the gathers need (with 1,024-slot tiles config 2's movie block ran
  // 22% longer and its user block 8%)
  constexpr int tile = 32 * 16;
  const size_t smem =
      2 * static_cast<size_t>(ProductSlots<kGather>::kSpan) *
      (tile + kColPad) * 4;
  als_stream_sums_kernel<kGather><<<static_cast<unsigned>(num_chunks), 32,
                                    smem, stream>>>(
      eq, x, row, seg, out, partials, n, num_rows, num_segments, tile);
}

// ---------------------------------------------------------------------------
// The ALS patch (als_patch_kernel): the (e, q) pairs after a (factor,
// block) of the compact ALS sweep (sparkfm_tpu_torch/solvers/als.py)
// whose block is column-pure (block b is slot b of every example), for
// every example n, with (e, q) = eq[n],
//
//   q' = q + delta[r] v
//   e' = (e + 0.5 (q' q' - q q)) - 0.5 (dsq[r] (v v)),
//   r = rank[n], v = vals[n],
//   eq[n] = (e', q'), or (e', q_next[n]) with kNext,
//
// with rank and vals the block's row of the (L, N) rank-space view and
// (delta, dsq) = table[r] the per-rank change of the factor and of its
// square, interleaved. A factor's last patch (kNext) loads the next
// factor's q into the q column: nothing reads q' after it. It replaces
// no TPU kernel: the JAX package and the sweep before it ran these lines
// as ~12 XLA or torch passes, each writing a 25M-long temporary that the
// next read back (~3.0 GB a call at N = 25M), and one kernel that reads
// each stream once is the whole gain.
//
// What bounds it: bytes. It reads rank, vals and eq and writes eq once,
// 24 bytes an example (28 with q_next): 600 MB at N = 25,000,095, a
// 179 us floor at 3.35 TB/s (209 us with q_next). The table (1.8 MB at U
// = 221,588) stays in L2 and, for the ranks an SM meets often, in L1. The
// design:
//
// * Each thread takes kPatchElems examples, kPatchThreads apart, so a
//   warp's loads of each stream are contiguous (128 bytes, 256 for eq),
//   and starts all their loads of the streams before the first is used;
//   then the gathers of the table, all in flight; then the arithmetic and
//   the stores. Scalar loads of rank and vals: the block's row sits at
//   element offset b N, off any 16-byte bound (12 bytes past one for b =
//   1 at config 2); eq is loaded and stored as float2.
// * One 8-byte gather an example: the movie block's ranks fall on
//   scattered movies, so most gathers miss L1 and fetch a 32-byte sector
//   from L2. With delta and dsq as two arrays that was two sectors an
//   example, and the call took 333 us against the user block's 200; the
//   interleaved table takes it to 213 us (PERF.md). Four examples a
//   thread measured as fast as eight, a persistent software-pipelined
//   form and a larger L1 carve-out no faster.
// * q_next in the same pass: ~259 us on the movie block and ~236 on the
//   user block, against ~236 / ~202 without it; the patch followed by a
//   strided copy of the next q into the column took ~411 / ~373 (PERF.md).
// * The streams are loaded and stored with the evict-first hint (ld/st
//   .cs), so they pass through the caches without pushing out the table,
//   which is read through the read-only path.
// * Numerics: torch's order, one rounding an operation, by __fmul_rn,
//   __fadd_rn and __fsub_rn, which the compiler does not contract into
//   FMAs, so q' and e' equal the torch lines bit for bit (v v is
//   torch.square's x x).
// * eq is written in place: each thread writes only the examples it has
//   read, and eq is not read through the read-only path.
//
// A rank outside [0, num_ranks) traps, before its table row is read.

constexpr int kPatchThreads = 256;
constexpr int kPatchElems = 4;         // examples a thread, kPatchThreads apart
constexpr int64_t kPatchTile = kPatchThreads * kPatchElems;

template <bool kNext>
__global__ void __launch_bounds__(kPatchThreads)
als_patch_kernel(float2* eq,                             // (N,): e, q in place
                 const float2* __restrict__ table,       // (U,): delta, dsq
                 const int32_t* __restrict__ rank,       // (N,)
                 const float* __restrict__ vals,         // (N,)
                 const float* __restrict__ q_next,       // (N,) if kNext
                 int64_t n, int64_t num_ranks) {
  const int64_t base = blockIdx.x * kPatchTile + threadIdx.x;
  int32_t r[kPatchElems];
  float v[kPatchElems], qx[kPatchElems];
  float2 p[kPatchElems], t[kPatchElems];
#pragma unroll
  for (int j = 0; j < kPatchElems; ++j) {
    const int64_t i = base + j * kPatchThreads;
    r[j] = 0;
    if (i < n) {
      r[j] = __ldcs(rank + i);
      v[j] = __ldcs(vals + i);
      p[j] = __ldcs(eq + i);
      if (kNext) qx[j] = __ldcs(q_next + i);
    }
  }
#pragma unroll
  for (int j = 0; j < kPatchElems; ++j) {
    if (base + j * kPatchThreads < n) {
      if (r[j] < 0 || r[j] >= num_ranks) __trap();
      t[j] = __ldg(table + r[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPatchElems; ++j) {
    const int64_t i = base + j * kPatchThreads;
    if (i < n) {
      const float e0 = p[j].x, q0 = p[j].y;
      const float qn = __fadd_rn(q0, __fmul_rn(t[j].x, v[j]));
      const float dq = __fsub_rn(__fmul_rn(qn, qn), __fmul_rn(q0, q0));
      const float en = __fsub_rn(
          __fadd_rn(e0, __fmul_rn(0.5f, dq)),
          __fmul_rn(0.5f, __fmul_rn(t[j].y, __fmul_rn(v[j], v[j]))));
      __stcs(eq + i, make_float2(en, kNext ? qx[j] : qn));
    }
  }
}

}  // namespace

extern "C" {

// Number of partial rows the caller of B3 or B4 allocates for N sorted
// slots at width k on a card of num_sms SMs: two per span, each 2k+2
// floats.
int64_t sfm_fm_grad_partial_rows(int64_t n, int64_t k, int64_t num_sms) {
  if (n <= 0) return 0;
  const int64_t span = fm_grad_span(n, k, static_cast<int>(num_sms));
  return 2 * ((n + span - 1) / span);
}

// B3 and B4 launch both passes on `stream` and return cudaGetLastError()
// (0 on success). They write every row of `out` (num_segments x (2k+2)),
// zeros for the ranks no slot has, so the caller need not fill it; the
// caller allocates `partials` (sfm_fm_grad_partial_rows rows of 2k+2
// floats), passes the L2 coefficients cv and cw as one float each in
// device memory, checks shapes and types (1 <= k <= 128), and keeps the
// tensors alive until the stream has run the kernels. B3 reads the unique
// rows vw_u (num_segments x (k+1)), B4 the per-slot rows vw_srt (N x
// (k+1)).
int sfm_fm_grad_segsum_factored(const float* vw_u, const float* ex,
                                const float* x, const int32_t* seg,
                                const float* cv, const float* cw,
                                float* out, float* partials, int64_t n,
                                int64_t num_segments, int64_t k,
                                int num_sms, void* stream) {
  return launch_fm_grad<false>(vw_u, ex, x, seg, cv, cw, out, partials, n,
                               num_segments, k, num_sms, stream);
}

int sfm_fm_grad_segsum(const float* vw_srt, const float* ex, const float* x,
                       const int32_t* seg, const float* cv, const float* cw,
                       float* out, float* partials, int64_t n,
                       int64_t num_segments, int64_t k, int num_sms,
                       void* stream) {
  return launch_fm_grad<true>(vw_srt, ex, x, seg, cv, cw, out, partials, n,
                              num_segments, k, num_sms, stream);
}

// B5 and B6 launch both passes on `stream` and return cudaGetLastError().
// They write every row of `out` (num_segments x W for B5, x 2W for B6;
// 16-byte aligned), zeros for the ranks no slot has; the caller checks
// shapes and types (1 <= W <= 65536 for B5, <= 32768 for B6), allocates
// `partials`, two rows of the output's width a chunk, and keeps the
// tensors alive until the stream has run the kernels. B5 runs on the
// staged tiles when `chunk` > 0 (the layout as B6's, below), else on the
// chunked kernel (kChunk slots a chunk).
int sfm_segment_rowsum(const float* g, const int32_t* seg, float* out,
                       float* partials, int64_t n, int64_t num_segments,
                       int64_t w, int64_t chunk, int64_t groups, int num_sms,
                       void* stream) {
  if (chunk > 0)
    return launch_rowsum_tiles<false>(g, seg, out, partials, n, num_segments,
                                      w, chunk, groups, num_sms, stream);
  return launch_rowsum_chunked(g, seg, out, partials, n, num_segments, w,
                               num_sms, stream);
}

// B6 takes its layout from the caller: `chunk` sorted slots a block in
// `groups` row groups (1 <= groups <= chunk, groups * min(W, 512) <= 512,
// the chunk's rows and ranks within 200 KB); `partials` holds two rows of
// 2W floats per chunk.
int sfm_segment_rowsum_sq(const float* g, const int32_t* seg, float* out,
                          float* partials, int64_t n, int64_t num_segments,
                          int64_t w, int64_t chunk, int64_t groups,
                          int num_sms, void* stream) {
  return launch_rowsum_tiles<true>(g, seg, out, partials, n, num_segments, w,
                                  chunk, groups, num_sms, stream);
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
  if (num_chunks > 1)
    colsums_crossing_kernel<<<crossing_blocks(num_chunks, num_sms),
                              kColThreads2, 0, st>>>(seg, partials, out, n,
                                                     si, num_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Launches both passes of the ALS stream sums on `stream` and returns
// cudaGetLastError() (0 on success): out[r] = the five sums of
// segment_colsums over [e_c x q_c, e_c x^2, x^2 q_c^2, x^3 q_c, x^4] with
// (e_c, q_c) = eq[row[i]] (eq[i] when `row` is null). eq holds num_rows
// (e, q) pairs (N when `row` is null), 8-byte aligned; x, row and seg N
// elements each, at any 4-byte offset; a row outside [0, num_rows) or a
// rank outside [0, num_segments) traps. The caller zero-fills `out`
// (num_segments x 5), allocates `partials` (sfm_colsums_partial_rows(n) x
// 5), checks shapes and types, and keeps the tensors alive until the
// stream has run the kernels.
int sfm_als_stream_sums(const float* eq, const float* x, const int32_t* row,
                        const int32_t* seg, float* out, float* partials,
                        int64_t n, int64_t num_rows, int64_t num_segments,
                        int num_sms, void* stream) {
  if (n <= 0) return 0;
  if (num_rows > INT32_MAX || reinterpret_cast<uintptr_t>(eq) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t num_chunks = (n + kColChunk - 1) / kColChunk;
  const float2* pairs = reinterpret_cast<const float2*>(eq);
  if (row != nullptr) {
    launch_als_stream_sums<true>(pairs, x, row, seg, out, partials, n,
                                 num_rows, num_segments, num_chunks, st);
  } else {
    launch_als_stream_sums<false>(pairs, x, row, seg, out, partials, n,
                                  num_rows, num_segments, num_chunks, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_chunks > 1)
    als_stream_sums_crossing_kernel<<<crossing_blocks(num_chunks, num_sms),
                                      kColThreads2, 0, st>>>(
        seg, partials, out, n, num_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Launches the ALS patch on `stream` and returns cudaGetLastError() (0 on
// success): for each of the N examples, in place, with (e, q) = eq[n], r =
// rank[n], v = vals[n] and (delta[r], dsq[r]) the two floats of table row
// r, q' = q + delta[r] v and e' = (e + 0.5 (q'^2 - q^2)) - 0.5 dsq[r] v^2,
// and eq[n] = (e', q'), or (e', q_next[n]) when `q_next` is not null.
// `eq` holds N pairs and `table` num_ranks rows, each 8-byte aligned;
// rank, vals and q_next N elements each, at any 4-byte offset; eq overlaps
// no other input. A rank outside [0, num_ranks) traps. The caller checks
// shapes and types and keeps the tensors alive until the stream has run
// the kernel.
int sfm_als_patch(float* eq, const float* table, const int32_t* rank,
                  const float* vals, const float* q_next, int64_t n,
                  int64_t num_ranks, int num_sms, void* stream) {
  (void)num_sms;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kPatchTile - 1) / kPatchTile;
  if (blocks > INT32_MAX || reinterpret_cast<uintptr_t>(eq) % 8 ||
      reinterpret_cast<uintptr_t>(table) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  float2* pairs = reinterpret_cast<float2*>(eq);
  const float2* rows = reinterpret_cast<const float2*>(table);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_next != nullptr)
    als_patch_kernel<true><<<static_cast<unsigned>(blocks), kPatchThreads, 0,
                             st>>>(pairs, rows, rank, vals, q_next, n,
                                   num_ranks);
  else
    als_patch_kernel<false><<<static_cast<unsigned>(blocks), kPatchThreads,
                              0, st>>>(pairs, rows, rank, vals, nullptr, n,
                                       num_ranks);
  return static_cast<int>(cudaGetLastError());
}

const char* sfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
