// The slot-major field-aware FM's loss and row gradients in one pass
// (ffm_slot_major_kernel). For a batch whose slot a holds a feature of
// field a (L = F slots an example), each slot's row is
//
//   row[b, a] = [ v_a[0] (K) | v_a[1] (K) | ... | v_a[F-1] (K) | w_a ]
//
// as the fused step's spread (sparkfm_tpu_torch/solvers/sgd_fused.py) lays
// it out, and the kernel computes, for every example b,
//
//   s_b = sum_{a<c} x_a x_c <v_a[c], v_c[a]> (+ sum_a w_a x_a) (+ w0)
//   ds_b = dloss/ds_b: logistic -y sigma(-y s) wt / D, squared 2 (s - y) wt / D
//   g_v[a][c] = ds_b x_a x_c v_c[a] (c != a; 0 on the diagonal block)
//               + 2 rv_a act_a / D2 * v_a[c]
//   g_w[a] = ds_b x_a (with the linear term) + 2 rw_a act_a / D2 * w_a
//
// with y in {-1, +1} (labels > 0 are +1), wt the example's mask weight (1
// without a mask), D the data loss's denominator (B, or max(sum wt,
// 1e-12)), act_a = wt if x_a != 0 else 0, D2 the L2 term's denominator (B,
// or max(sum wt, 1)), and rv, rw the L2 strengths (scalars, or per slot).
// It writes s and ds per example and one [g_v | g_w] row per slot, in the
// rows' own layout: the gradient of solvers/sgd.py::_batch_loss_from_rows
// with respect to the rows, which torch.autograd.grad formed before.
//
// It replaces no TPU kernel: the JAX package left this math to XLA, and
// the port ran it as autograd over (B, F, F, K) tensors, a dozen strided
// elementwise passes over ~1.6 GB each at the ffm-train-criteo cell's
// shape (B = 65,536, F = 39, K = 4), 25 ms a step (PERF.md).
//
// What bounds it: bytes. It reads each slot's row (F K + 1 floats) and
// value once and writes each slot's gradient row once, plus the labels and
// two floats an example: at the cell's shape 3.22 GB, a 0.96 ms floor at
// 3.35 TB/s, against ~6 flops a float moved. The forward and the backward
// share one read, which a forward kernel and a backward kernel would not
// (two reads of the rows: a third more bytes). The design:
//
// * One block an example. Its rows are one contiguous block of F (F K + 1)
//   floats (24,492 bytes at the cell's shape), staged in shared memory by
//   one bulk copy (csrc/bulk_copy.cuh): the rows are 4 (F K + 1) bytes
//   long, so an example's block starts 0, 4, 8 or 12 bytes past a 16-byte
//   bound, and the tile keeps it at that offset, so that the block rounded
//   out to 16-byte bounds is one aligned copy. The copy is issued by one
//   thread and costs no registers; while it lands the block loads the
//   example's values and forms the slots' L2 coefficients. An example whose
//   rounded copy would leave the tensor is loaded by the threads.
// * The score: a thread a pair (a, c) at a time, reading the two K-vectors
//   v_a[c] and v_c[a] from the tile, then a warp-shuffle and a block
//   reduction; one thread forms ds.
// * The gradient: a thread an output float at a time, in order, so a
//   warp's stores are 32 consecutive floats of the example's contiguous
//   output block. Each reads its own float of the tile (the L2 term) and
//   the transposed one, v_c[a][k] (the pair term); K is a template
//   parameter, so the lane's (c, k) is a shift and a mask.
// * Filling the card: 128 threads a block and ~25 KB of shared memory at
//   the cell's shape, so 8 blocks an SM are resident: while some wait on
//   their copies, the others compute and store.
// * Numerics: float32 throughout, sums in another order than autograd's
//   (the pair sum over a thread's pairs, then the warp's and the block's),
//   so the score differs from the torch route by float32 rounding only.
//
// K is 1, 2, 4, 8 or 16 (the launcher refuses another). The caller sizes
// the shared memory and says which F and K it takes
// (ops/interaction.py::slot_major_tile_floats, slot_major_kernel_takes):
// this file keeps no copy of that rule.

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// flags
constexpr int kLogistic = 1;
constexpr int kBias = 2;
constexpr int kLinear = 4;

template <int K>
__global__ void __launch_bounds__(kThreads)
ffm_slot_major_kernel(const float* __restrict__ rows,  // (B, F, F K + 1)
                      const float* __restrict__ vals,  // (B, F)
                      const float* __restrict__ y,     // (B,)
                      const float* __restrict__ mask,  // (B,) or null
                      const float* __restrict__ wsum,  // () or null
                      const float* __restrict__ w0,    // () or null
                      const float* __restrict__ rv,    // (B, F) or null
                      const float* __restrict__ rw,    // (B, F) or null
                      float reg_v, float reg_w, float data_scale,
                      float l2_scale,
                      float* __restrict__ g,           // (B, F, F K + 1)
                      float* __restrict__ scores,      // (B,)
                      float* __restrict__ dlds,        // (B,)
                      int64_t batch, int fields, int tile_floats,
                      int flags) {
  // dynamic shared memory: tile_floats floats for the tile at its offset
  // past a 16-byte bound and its copy's rounding, then 3 F floats
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[kWarps];
  __shared__ float ds_shared;
  const int t = threadIdx.x;
  const int w = fields * K + 1;           // a row: [v (F K) | w]
  const int vk = fields * K;
  const int n = fields * w;               // an example's floats
  const int64_t b = blockIdx.x;
  const int64_t first = b * n;

  // tile[i] = rows[first + i], at the copy's offset past a 16-byte bound
  const float* const src = rows + first;
  const int ph = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2 & 3);
  float* const tile = smem + ph;
  float* const xs = smem + tile_floats;   // x_a
  float* const cv = xs + fields;                     // 2 rv_a act_a / D2
  float* const cw = cv + fields;                     // 2 rw_a act_a / D2
  const int copy_floats = (ph + n + 3) / 4 * 4;
  const bool by_copy = first >= ph && first - ph + copy_floats <= batch * n;
  if (t == 0 && by_copy) {
    sfm::mbar_init(&bar, 1);
    sfm::mbar_init_fence();
    sfm::mbar_expect_bytes(&bar, copy_floats * 4u);
    sfm::bulk_load(smem, src - ph, copy_floats * 4u, &bar);
  }
  if (!by_copy)
    for (int i = t; i < n; i += kThreads) tile[i] = src[i];

  // while the copy lands: the slots' values and L2 coefficients
  const float wt = mask != nullptr ? mask[b] : 1.f;
  float dscale = data_scale, l2 = l2_scale;
  if (wsum != nullptr) {
    const float s = *wsum;
    dscale = 1.f / fmaxf(s, 1e-12f);
    l2 = 2.f / fmaxf(s, 1.f);
  }
  for (int a = t; a < fields; a += kThreads) {
    const int64_t i = b * fields + a;
    const float x = vals[i];
    const float act = x != 0.f ? wt : 0.f;
    xs[a] = x;
    cv[a] = l2 * (rv != nullptr ? rv[i] : reg_v) * act;
    cw[a] = l2 * (rw != nullptr ? rw[i] : reg_w) * act;
  }
  __syncthreads();
  if (by_copy) sfm::mbar_wait(&bar, 0);

  // the score: the pairs a < c, then the linear term
  float part = 0.f;
  for (int i = t; i < fields * fields; i += kThreads) {
    const int a = i / fields;
    const int c = i - a * fields;
    if (a < c) {
      const float* const va = tile + a * w + c * K;
      const float* const vc = tile + c * w + a * K;
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) dot = fmaf(va[k], vc[k], dot);
      part = fmaf(xs[a] * xs[c], dot, part);
    }
  }
  if (flags & kLinear)
    for (int a = t; a < fields; a += kThreads)
      part = fmaf(tile[a * w + vk], xs[a], part);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  if ((t & 31) == 0) red[t >> 5] = part;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i];
    if (flags & kBias) s += *w0;
    const float yb = y[b];
    float d;
    if (flags & kLogistic) {
      const float ypm = yb > 0.f ? 1.f : -1.f;
      d = -ypm / (1.f + expf(ypm * s));          // -y sigma(-y s)
    } else {
      d = 2.f * (s - yb);
    }
    d = d * wt * dscale;
    scores[b] = s;
    dlds[b] = d;
    ds_shared = d;
  }
  __syncthreads();
  const float d = ds_shared;

  // the gradient rows, float e = (a, j) of the example's block in order
  float* const dst = g + first;
  const int da = kThreads / w;
  const int dj = kThreads - da * w;
  int a = t / w;
  int j = t - a * w;
  for (int e = t; e < n; e += kThreads) {
    const float v = tile[e];
    float out;
    if (j < vk) {
      const int c = j / K;
      const int k = j - c * K;
      const float pair =
          c != a ? d * xs[a] * xs[c] * tile[c * w + a * K + k] : 0.f;
      out = fmaf(cv[a], v, pair);
    } else {
      out = fmaf(cw[a], v, (flags & kLinear) ? d * xs[a] : 0.f);
    }
    dst[e] = out;
    j += dj;
    a += da;
    if (j >= w) {
      j -= w;
      ++a;
    }
  }
}

template <int K>
cudaError_t launch_slot_major(const float* rows, const float* vals,
                              const float* y, const float* mask,
                              const float* wsum, const float* w0,
                              const float* rv, const float* rw, float reg_v,
                              float reg_w, float data_scale, float l2_scale,
                              float* g, float* scores, float* dlds,
                              int64_t batch, int fields, int tile_floats,
                              int smem, int flags, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ffm_slot_major_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  ffm_slot_major_kernel<K><<<static_cast<unsigned>(batch), kThreads, smem,
                             stream>>>(
      rows, vals, y, mask, wsum, w0, rv, rw, reg_v, reg_w, data_scale,
      l2_scale, g, scores, dlds, batch, fields, tile_floats, flags);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the slot-major FFM loss and row gradients on `stream` and
// returns cudaGetLastError() (0 on success): for each of the `batch`
// examples, from its F = `fields` rows of F k + 1 floats (contiguous, at
// any 4-byte offset), its F values, its label and, where given, its mask
// weight, writes its score and dloss/ds and its F gradient rows (the
// module note above). `mask`, `wsum` (the mask's sum, which then sets both
// denominators), `w0` (read with kBias), `rv` and `rw` (per-slot L2
// strengths, else the scalars) may be null. flags: 1 logistic loss (else
// squared), 2 the bias, 4 the linear term. k must be 1, 2, 4, 8 or 16.
// `tile_floats`, the floats the tile takes in shared memory, and `smem`,
// the block's bytes, are the caller's (slot_major_tile_floats). The
// caller checks shapes and types and keeps the tensors alive until the
// stream has run the kernel.
int sfm_ffm_slot_major(const float* rows, const float* vals, const float* y,
                       const float* mask, const float* wsum, const float* w0,
                       const float* rv, const float* rw, float reg_v,
                       float reg_w, float data_scale, float l2_scale,
                       float* g, float* scores, float* dlds, int64_t batch,
                       int fields, int k, int tile_floats, int smem,
                       int flags, int num_sms, void* stream) {
  (void)num_sms;
  if (batch <= 0) return 0;
  if (batch > INT32_MAX || fields < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
#define SFM_CASE(KK)                                                        \
  case KK:                                                                  \
    err = launch_slot_major<KK>(rows, vals, y, mask, wsum, w0, rv, rw,     \
                                reg_v, reg_w, data_scale, l2_scale, g,      \
                                scores, dlds, batch, fields, tile_floats,   \
                                smem, flags, st);                           \
    break;
    SFM_CASE(1)
    SFM_CASE(2)
    SFM_CASE(4)
    SFM_CASE(8)
    SFM_CASE(16)
#undef SFM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* sfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
