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
// write puts the updated records back (sparkfm_tpu_torch/solvers/
// sgd_hybrid.py, sgd_fused.py, sgd_sorted.py).
//
// What bounds them: bytes. A call reads U*W*4 bytes of rows plus U*4 bytes
// of ids and writes U*W*4 bytes; it does no arithmetic. At the sizes of one
// batch (tens of thousands of rows of 32 to 68 floats, a few MB) the copy
// itself lasts microseconds at HBM rate.
//
// The gather: one warp per row, in a grid-stride loop. Lane 0 reads the id
// and shares it with the warp by shuffle; the lanes then stride the row,
// with 16-byte float4 accesses when W % 4 == 0 and both base pointers are
// 16-byte aligned, scalar accesses otherwise. Offsets are 64-bit, since
// R * W can pass 2^31 for wide records. An id outside [0, R) traps the
// kernel rather than touching memory out of bounds.
//
// The write. Its ids are unique except for the plan's fill row, which the
// unused budget slots at the tail of the ascending uids repeat: a device
// plan (ops/embedding.py::dedup_ids) has a static budget of 2^18 slots for
// ~40k uniques, so ~222k slots name the fill row. Rule: slot r writes only
// if r == 0 or ids[r] != ids[r - 1]. A run of equal ids therefore leaves
// the run's first row, and the repeats cost one id read each. Ids that
// repeat without being adjacent still race, as on the TPU.
//
// Work is cut into tiles of at most 32 consecutive slots, one per warp at a
// time: lane l reads ids[r0 + l] and ids[r0 + l - 1], a ballot gives the
// tile's rows to write, and a tile with none (the fill tail) is done. The
// warp then copies the tile's kept rows element by element with all 32
// lanes busy, float4 when aligned (a 68-float record is 17 float4s, which
// one warp per row would spread over 17 of 32 lanes). A tile holds as many
// rows as 8 elements per lane cover (15 records of 17 float4s), so each
// lane issues all its loads before its stores, one round trip per tile.
// (A route by Hopper's bulk copy engine, one bulk store per kept row from
// double-buffered shared memory, measured slower at the main path's ladder
// and device-plan shapes on the H100; PERF.md keeps its times.)

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kTileRows = 32;                 // write: most slots per tile
constexpr int kUnroll = 8;                    // write: loads per lane
constexpr int64_t kMaxWriteWidth = 1 << 24;   // tile offsets stay 32-bit

// One warp per row r: out[r] = table[ids[r]].
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ ids, float* __restrict__ out,
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
    id = __shfl_sync(kFull, id, 0);
    if (id < 0 || static_cast<int64_t>(id) >= num_rows) __trap();
    const float* s = table + static_cast<int64_t>(id) * width;
    float* d = out + r * width;
    if (vec4) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      float4* d4 = reinterpret_cast<float4*>(d);
      for (int64_t c = lane; c < width / 4; c += 32) d4[c] = __ldg(s4 + c);
    } else {
      for (int64_t c = lane; c < width; c += 32) d[c] = __ldg(s + c);
    }
  }
}

// The write: grid-stride over tiles of tile_rows slots, one warp each. V
// is float4 (W % 4 == 0, aligned) or float; wv is the row width in V.
template <typename V>
__global__ void __launch_bounds__(kThreads)
row_write_kernel(const V* __restrict__ rows,
                       const int32_t* __restrict__ ids,
                       V* __restrict__ table, int64_t num_rows, uint32_t wv,
                       int tile_rows, int64_t num_ids) {
  const int lane = threadIdx.x & 31;
  const int64_t step =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * tile_rows;
  for (int64_t r0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                     (threadIdx.x >> 5)) * tile_rows;
       r0 < num_ids; r0 += step) {
    const int64_t end = num_ids - r0 < tile_rows ? num_ids : r0 + tile_rows;
    // lane l's id, and the ballot of the slots that write (the first of
    // each run of equal ids)
    const int64_t r = r0 + lane;
    int32_t id = 0;
    bool keep = false;
    if (r < end) {
      id = ids[r];
      if (id < 0 || static_cast<int64_t>(id) >= num_rows) __trap();
      keep = r == 0 || ids[r - 1] != id;
    }
    const unsigned kept = __ballot_sync(kFull, keep);
    if (kept == 0) continue;                    // warp-uniform
    const uint32_t n = static_cast<uint32_t>(end - r0) * wv;
    const V* src = rows + r0 * wv;
    for (uint32_t base = 0; base < n; base += 32 * kUnroll) {
      V v[kUnroll] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t j = base + u * 32 + lane;
        if (j < n) v[u] = __ldg(src + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t j = base + u * 32 + lane;
        const uint32_t row = j < n ? j / wv : 0;
        const int32_t to = __shfl_sync(kFull, id, row);
        if (j < n && (kept >> row & 1u))
          table[static_cast<int64_t>(to) * wv + (j - row * wv)] = v[u];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_gather(const float* table, const int32_t* ids, float* out,
                  int64_t num_rows, int64_t width, int64_t num_ids,
                  int num_sms, cudaStream_t stream) {
  if (num_ids <= 0 || width <= 0) return 0;
  // Enough blocks to fill every SM (2048 threads each), then grid-stride.
  int64_t blocks = (num_ids + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t resident = static_cast<int64_t>(num_sms) * (2048 / kThreads);
  if (blocks > resident) blocks = resident;
  const bool vec4 = width % 4 == 0 && aligned16(table) && aligned16(out);
  gather_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table, ids, out, num_rows, width, num_ids, vec4);
  return static_cast<int>(cudaGetLastError());
}

int launch_write(const float* rows, const int32_t* ids, float* table,
                 int64_t num_rows, int64_t width, int64_t num_ids,
                 int num_sms, cudaStream_t stream) {
  if (num_ids <= 0 || width <= 0) return 0;
  if (width > kMaxWriteWidth) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = width % 4 == 0 && aligned16(table) && aligned16(rows);
  const uint32_t wv = static_cast<uint32_t>(vec4 ? width / 4 : width);
  int tile_rows = static_cast<int>(32 * kUnroll / wv);
  tile_rows = tile_rows < 1 ? 1 : tile_rows > kTileRows ? kTileRows
                                                        : tile_rows;
  const int64_t tiles = (num_ids + tile_rows - 1) / tile_rows;
  int64_t blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t resident = static_cast<int64_t>(num_sms) * (2048 / kThreads);
  if (blocks > resident) blocks = resident;
  const unsigned b = static_cast<unsigned>(blocks);
  if (vec4) {
    row_write_kernel<float4><<<b, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(rows), ids,
        reinterpret_cast<float4*>(table), num_rows, wv, tile_rows, num_ids);
  } else {
    row_write_kernel<float><<<b, kThreads, 0, stream>>>(
        rows, ids, table, num_rows, wv, tile_rows, num_ids);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// All launch on `stream` and return cudaGetLastError() (0 on success);
// `num_sms` is the card's SM count, which the caller looks up once per
// device. The caller allocates `out` (num_ids x width), checks shapes and
// types, and keeps the tensors alive until the stream has run the kernel.
int sfm_gather_rows(const float* table, const int32_t* ids, float* out,
                    int64_t num_rows, int64_t width, int64_t num_ids,
                    int num_sms, void* stream) {
  return launch_gather(table, ids, out, num_rows, width, num_ids, num_sms,
                       static_cast<cudaStream_t>(stream));
}

int sfm_scatter_rows(float* table, const int32_t* ids, const float* rows,
                     int64_t num_rows, int64_t width, int64_t num_ids,
                     int num_sms, void* stream) {
  return launch_write(rows, ids, table, num_rows, width, num_ids, num_sms,
                      static_cast<cudaStream_t>(stream));
}

const char* sfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
