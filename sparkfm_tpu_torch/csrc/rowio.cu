// Row gather and row write for the unique-row plan:
//   gather:  out[r, :] = table[ids[r], :]
//   two-table gather:  out[r, :] = [ table[ids[r], :] | column[ids[r]] ]
//   write:   table[ids[r], :] = rows[r, :]   (in place)
//
// The gathers replace the TPU kernel
// sparkfm_tpu/ops/pallas_rowio.py::_gather_kernel (called through
// gather_rows_pallas), the write replaces _writer_kernel (called through
// scatter_set_rows). Both issued one HBM->HBM row DMA per id from the TPU's
// scalar core, eight copies in flight. On the serving path the two-table
// gather reads each unique row of the V table and of the w column once and
// writes the (U, K+1) [v | w] rows in one launch
// (sparkfm_tpu_torch/models/fm.py::scores; the JAX package gathers V and w
// apart and concatenates); on the training path the gather reads each
// unique fused record [v | slot_v | w | slot_w | pad] once, and the write
// puts the updated records back (sparkfm_tpu_torch/solvers/sgd_hybrid.py,
// sgd_fused.py, sgd_sorted.py).
//
// What bounds them: bytes. A call reads U*W*4 bytes of rows plus U*4 bytes
// of ids and writes U*W*4 bytes; it does no arithmetic. At the sizes of one
// batch (tens of thousands of rows of 32 to 68 floats, a few MB) the copy
// itself lasts microseconds at HBM rate, so the launch, the dependent id ->
// row load and how many loads are in flight set the time.
//
// Both work in tiles of consecutive slots, one warp per tile at a time: lane
// l reads ids[r0 + l] (and checks it), and the warp then copies the tile's
// rows element by element with all 32 lanes busy, float4 when W % 4 == 0
// and the pointers are 16-byte aligned (a 68-float record is 17 float4s,
// which one warp per row would spread over 17 of 32 lanes). A tile holds
// as many rows as 8 elements per lane cover (32 rows of V's 8 float4s, 15
// records of 17 float4s, 7 rows of [v | w]'s 33 floats, 32 w values), so
// each lane issues all its loads before its stores, one round trip per
// tile; an id out of [0, R) traps the kernel before any row is read.
//
// The gather: element e of a tile is out[r0 * W + e], so a tile's stores
// are one contiguous range, and its loads are runs of W contiguous
// elements per row. At W = 1 (the w column, before the two-table form) one
// warp per row left 31 lanes idle; here a warp moves 32 rows. The
// two-table gather tiles its (K + 1)-float out rows the same way.
//
// The write. Its ids are unique except for the plan's fill row, which the
// unused budget slots at the tail of the ascending uids repeat: a device
// plan (ops/embedding.py::dedup_ids) has a static budget of 2^18 slots for
// ~40k uniques, so ~222k slots name the fill row. Rule: slot r writes only
// if r == 0 or ids[r] != ids[r - 1]. A run of equal ids therefore leaves
// the run's first row, and the repeats cost one id read each. Ids that
// repeat without being adjacent still race, as on the TPU. A ballot gives
// the tile's rows to write, and a tile with none (the fill tail) is done.
// (A route by Hopper's bulk copy engine, one bulk store per kept row from
// double-buffered shared memory, measured slower at the main path's ladder
// and device-plan shapes on the H100; PERF.md keeps its times.)

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kTileRows = 32;                 // most slots per tile
constexpr int kUnroll = 8;                    // loads per lane per round
constexpr int64_t kMaxWidth = 1 << 24;        // tile offsets stay 32-bit

// The gather: grid-stride over tiles of tile_rows slots, one warp each.
// V is float4 (W % 4 == 0, aligned) or float; wv is the row width in V.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_tiles_kernel(const V* __restrict__ table,
                    const int32_t* __restrict__ ids, V* __restrict__ out,
                    int64_t num_rows, uint32_t wv, int tile_rows,
                    int64_t num_ids) {
  const int lane = threadIdx.x & 31;
  const int64_t step =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * tile_rows;
  for (int64_t r0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                     (threadIdx.x >> 5)) * tile_rows;
       r0 < num_ids; r0 += step) {
    const int64_t end = num_ids - r0 < tile_rows ? num_ids : r0 + tile_rows;
    int32_t id = 0;
    if (r0 + lane < end) {
      id = ids[r0 + lane];
      if (id < 0 || static_cast<int64_t>(id) >= num_rows) __trap();
    }
    const uint32_t n = static_cast<uint32_t>(end - r0) * wv;
    V* dst = out + r0 * wv;
    for (uint32_t base = 0; base < n; base += 32 * kUnroll) {
      V v[kUnroll] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t j = base + u * 32 + lane;
        const uint32_t row = j < n ? j / wv : 0;
        const int64_t from = __shfl_sync(kFull, id, row);
        if (j < n) v[u] = __ldg(table + from * wv + (j - row * wv));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t j = base + u * 32 + lane;
        if (j < n) dst[j] = v[u];
      }
    }
  }
}

// The two-table gather, out[r] = [table[ids[r]] | column[ids[r]]] (W + 1
// floats a row): element e of a tile is out[r0 * (W + 1) + e], a table
// element or, at the end of each row, the column's; float by float, so the
// tile's stores are one contiguous range and its loads runs of W floats.
// (Float4 reads of the table with float-by-float stores, 32 rows a tile,
// measured slower at the serving shape on the H100; PERF.md keeps the
// times.)
__global__ void __launch_bounds__(kThreads)
gather_vw_kernel(const float* __restrict__ table,
                 const float* __restrict__ column,
                 const int32_t* __restrict__ ids, float* __restrict__ out,
                 int64_t num_rows, uint32_t w, int tile_rows,
                 int64_t num_ids) {
  const int lane = threadIdx.x & 31;
  const uint32_t ow = w + 1;
  const int64_t step =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * tile_rows;
  for (int64_t r0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                     (threadIdx.x >> 5)) * tile_rows;
       r0 < num_ids; r0 += step) {
    const int64_t end = num_ids - r0 < tile_rows ? num_ids : r0 + tile_rows;
    int32_t id = 0;
    if (r0 + lane < end) {
      id = ids[r0 + lane];
      if (id < 0 || static_cast<int64_t>(id) >= num_rows) __trap();
    }
    const uint32_t n = static_cast<uint32_t>(end - r0) * ow;
    float* dst = out + r0 * ow;
    for (uint32_t base = 0; base < n; base += 32 * kUnroll) {
      float v[kUnroll] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t j = base + u * 32 + lane;
        const uint32_t row = j < n ? j / ow : 0;
        const uint32_t col = j - row * ow;
        const int64_t from = __shfl_sync(kFull, id, row);
        if (j < n)
          v[u] = col < w ? __ldg(table + from * w + col)
                         : __ldg(column + from);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t j = base + u * 32 + lane;
        if (j < n) dst[j] = v[u];
      }
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

// Tile rows for out rows of ow elements: as many as 8 elements per lane
// cover, 1 to 32.
int tile_rows_for(uint32_t ow) {
  const uint32_t rows = 32u * kUnroll / ow;
  return rows < 1 ? 1 : rows > kTileRows ? kTileRows : static_cast<int>(rows);
}

unsigned blocks_for(int64_t num_ids, int tile_rows, int num_sms) {
  const int64_t tiles = (num_ids + tile_rows - 1) / tile_rows;
  int64_t blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t resident = static_cast<int64_t>(num_sms) * (2048 / kThreads);
  return static_cast<unsigned>(blocks > resident ? resident : blocks);
}

// table (R, width), and with `column` (R,) a two-table gather into
// (U, width + 1) rows.
int launch_gather(const float* table, const float* column,
                  const int32_t* ids, float* out, int64_t num_rows,
                  int64_t width, int64_t num_ids, int num_sms,
                  cudaStream_t stream) {
  if (num_ids <= 0 || width <= 0) return 0;
  if (width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (column != nullptr) {
    const uint32_t w = static_cast<uint32_t>(width);
    const int rows = tile_rows_for(w + 1);
    gather_vw_kernel<<<blocks_for(num_ids, rows, num_sms), kThreads, 0,
                       stream>>>(table, column, ids, out, num_rows, w, rows,
                                 num_ids);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec4 = width % 4 == 0 && aligned16(table) && aligned16(out);
  const uint32_t wv = static_cast<uint32_t>(vec4 ? width / 4 : width);
  const int rows = tile_rows_for(wv);
  const unsigned blocks = blocks_for(num_ids, rows, num_sms);
  if (vec4) {
    gather_tiles_kernel<float4><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(table), ids,
        reinterpret_cast<float4*>(out), num_rows, wv, rows, num_ids);
  } else {
    gather_tiles_kernel<float><<<blocks, kThreads, 0, stream>>>(
        table, ids, out, num_rows, wv, rows, num_ids);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_write(const float* rows, const int32_t* ids, float* table,
                 int64_t num_rows, int64_t width, int64_t num_ids,
                 int num_sms, cudaStream_t stream) {
  if (num_ids <= 0 || width <= 0) return 0;
  if (width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = width % 4 == 0 && aligned16(table) && aligned16(rows);
  const uint32_t wv = static_cast<uint32_t>(vec4 ? width / 4 : width);
  const int tile_rows = tile_rows_for(wv);
  const unsigned b = blocks_for(num_ids, tile_rows, num_sms);
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
  return launch_gather(table, nullptr, ids, out, num_rows, width, num_ids,
                       num_sms, static_cast<cudaStream_t>(stream));
}

// The two-table gather: out (num_ids x (width + 1)) row r = [table[ids[r]]
// (width) | column[ids[r]]], for a (num_rows x width) table and a
// (num_rows,) column.
int sfm_gather_vw_rows(const float* table, const float* column,
                       const int32_t* ids, float* out, int64_t num_rows,
                       int64_t width, int64_t num_ids, int num_sms,
                       void* stream) {
  return launch_gather(table, column, ids, out, num_rows, width, num_ids,
                       num_sms, static_cast<cudaStream_t>(stream));
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
