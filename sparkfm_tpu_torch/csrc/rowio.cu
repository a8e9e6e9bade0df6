// Row gather for the unique-row plan: out[r, :] = table[ids[r], :].
//
// Replaces the TPU kernel sparkfm_tpu/ops/pallas_rowio.py::_gather_kernel
// (called through gather_rows_pallas), which issued one HBM->HBM row DMA per
// id from the TPU's scalar core, eight copies in flight. On the serving path
// it reads each unique row of the V table and of the w column once
// (sparkfm_tpu_torch/models/fm.py::scores).
//
// What bounds it: bytes. A call reads U*W*4 bytes of table rows plus U*4
// bytes of ids and writes U*W*4 bytes; it does no arithmetic. At serving
// sizes (tens of thousands of rows of 32 floats, a few MB) the copy itself
// lasts microseconds at HBM rate, so the launch is a large share of a call.
//
// Design: one warp per output row, in a grid-stride loop. Lane 0 reads the
// id and shares it with the warp by shuffle; the lanes then stride the row,
// with 16-byte float4 accesses when W % 4 == 0 and both base pointers are
// 16-byte aligned, scalar accesses otherwise. A rank-32 row is eight float4
// loads by neighbouring lanes, one 128-byte segment, and every warp's row
// is independent of every other's: no shared memory, no synchronisation,
// and tens of thousands of row reads in flight to hide HBM latency, where
// the TPU had to issue its row copies one by one. Narrow rows (W = 1, the w
// column) leave most lanes idle; that costs nothing measurable at serving
// sizes and keeps one code path for every width. Offsets are 64-bit, since
// R * W can pass 2^31 for wider records. An id outside [0, R) traps the
// kernel rather than reading out of bounds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ ids,
                   float* __restrict__ out,
                   int64_t num_rows, int64_t width, int64_t num_ids,
                   bool vec4) {
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
    const float* src = table + static_cast<int64_t>(id) * width;
    float* dst = out + r * width;
    if (vec4) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int64_t c = lane; c < width / 4; c += 32) dst4[c] = __ldg(src4 + c);
    } else {
      for (int64_t c = lane; c < width; c += 32) dst[c] = __ldg(src + c);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (num_ids x width) and checks shapes and types.
int sfm_gather_rows(const float* table, const int32_t* ids, float* out,
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
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gather_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      table, ids, out, num_rows, width, num_ids, vec4);
  return static_cast<int>(cudaGetLastError());
}

const char* sfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
