// Row gather and row write for the unique-row plan:
//   gather:  out[r, :] = table[ids[r], :]
//   write:   table[ids[r], :] = rows[r, :]   (in place)
//
// The gather replaces the TPU kernel
// sparkfm_tpu/ops/pallas_rowio.py::_gather_kernel (called through
// gather_rows_pallas), the write replaces _writer_kernel (called through
// scatter_set_rows). Both issued one HBM->HBM row DMA per id from the TPU's
// scalar core, eight copies in flight. On the serving path the gather reads
// each unique row of the V table and of the w column once
// (sparkfm_tpu_torch/models/fm.py::scores); on the training path it reads
// each unique fused record [v | slot_v | w | slot_w | pad] once, and the
// write puts the updated records back
// (sparkfm_tpu_torch/solvers/sgd_hybrid.py).
//
// What bounds them: bytes. A call reads U*W*4 bytes of rows plus U*4 bytes
// of ids and writes U*W*4 bytes; it does no arithmetic. At the sizes of one
// batch (tens of thousands of rows of 32 to 68 floats, a few MB) the copy
// itself lasts microseconds at HBM rate, so the launch is a large share of
// a call.
//
// Design: one warp per row, in a grid-stride loop. Lane 0 reads the id and
// shares it with the warp by shuffle; the lanes then stride the row, with
// 16-byte float4 accesses when W % 4 == 0 and both base pointers are
// 16-byte aligned, scalar accesses otherwise. A rank-32 row is eight float4
// accesses by neighbouring lanes, one 128-byte segment, and every warp's
// row is independent of every other's: no shared memory, no
// synchronisation, and tens of thousands of rows in flight to hide HBM
// latency, where the TPU had to issue its row copies one by one. Narrow
// rows (W = 1, the w column) leave most lanes idle. Offsets are 64-bit,
// since R * W can pass 2^31 for wide records. An id outside [0, R) traps
// the kernel rather than touching memory out of bounds.
//
// The write's ids are unique except for the plan's fill row, which unused
// budget slots repeat: those warps race on the fill row, whose content is
// unspecified by contract (as on the TPU), and every other row has exactly
// one writer.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / 32;

// One warp per row r: copies src row (ids[r] when gathering, r when
// writing) to dst row (r when gathering, ids[r] when writing).
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
row_copy_kernel(const float* __restrict__ src, const int32_t* __restrict__ ids,
                float* __restrict__ dst, int64_t num_rows, int64_t width,
                int64_t num_ids, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int64_t num_warps =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       r < num_ids; r += num_warps) {
    int32_t id = 0;
    if (lane == 0) id = ids[r];
    id = __shfl_sync(0xffffffffu, id, 0);
    if (id < 0 || static_cast<int64_t>(id) >= num_rows) __trap();
    const int64_t from = kWrite ? r : id;
    const int64_t to = kWrite ? id : r;
    const float* s = src + from * width;
    float* d = dst + to * width;
    if (vec4) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      float4* d4 = reinterpret_cast<float4*>(d);
      for (int64_t c = lane; c < width / 4; c += 32) d4[c] = __ldg(s4 + c);
    } else {
      for (int64_t c = lane; c < width; c += 32) d[c] = __ldg(s + c);
    }
  }
}

template <bool kWrite>
int launch_row_copy(const float* src, const int32_t* ids, float* dst,
                    int64_t num_rows, int64_t width, int64_t num_ids,
                    void* stream) {
  if (num_ids <= 0 || width <= 0) return 0;
  int device = 0;
  int num_sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Enough blocks to fill every SM (2048 threads each), then grid-stride.
  int64_t blocks = (num_ids + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t resident = static_cast<int64_t>(num_sms) * (2048 / kThreads);
  if (blocks > resident) blocks = resident;
  const bool vec4 = width % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  row_copy_kernel<kWrite><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      src, ids, dst, num_rows, width, num_ids, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// The caller allocates `out` (num_ids x width), checks shapes and types,
// and keeps the tensors alive until the stream has run the kernel.
int sfm_gather_rows(const float* table, const int32_t* ids, float* out,
                    int64_t num_rows, int64_t width, int64_t num_ids,
                    void* stream) {
  return launch_row_copy<false>(table, ids, out, num_rows, width, num_ids,
                                stream);
}

int sfm_scatter_rows(float* table, const int32_t* ids, const float* rows,
                     int64_t num_rows, int64_t width, int64_t num_ids,
                     void* stream) {
  return launch_row_copy<true>(rows, ids, table, num_rows, width, num_ids,
                               stream);
}

const char* sfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
