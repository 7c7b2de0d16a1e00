// Row-wise fused merge-apply over premerged unique lanes.
//
// Replaces the TPU kernel paddlebox_tpu/ops/pallas_kernels.py::
// _scatter_accumulate_kernel (wrapper scatter_accumulate). Contract (the
// plain PyTorch statement is ops/kernels.py::scatter_accumulate_plain):
//   table (n_rows, W) f32, W <= 512, updated IN PLACE — the counterpart
//         of the TPU kernel's input_output_aliases: rows that no valid
//         lane names are never read or written and keep their exact bits
//   idx   (n,) int32, one lane per touched row: ids are unique among
//         valid lanes, so no two warps touch one row and no atomics are
//         needed
//   grads (n, grad_width) f32 (row stride given), shows/clks (n,) f32
//         (element strides given) — the merged per-row payload
//   touched (n,) int32 or null; a lane is valid iff 0 <= idx < n_rows
//         and (touched == null or touched > 0). An invalid lane (pad)
//         returns before any read or write, so a pad can never clobber a
//         real row's update.
// Per valid lane: read the row, run apply_updates (apply_updates.cuh),
// write it back.
//
// Bound on an H100: memory. Each valid lane reads and writes one row of
// W*4 bytes at a random table location plus its payload; the optimizer's
// few flops per column are free. Design: one warp per lane, so each row
// is one coalesced read and one coalesced write, the per-row means are
// warp shuffles, and nothing touches a row twice. Pad lanes cost one idx
// read each.
#include <cuda_runtime.h>

#include <cstdint>

#include "apply_updates.cuh"

namespace {

constexpr int kThreads = 256;

template <int OPT>
__global__ void scatter_accumulate_kernel(
    float* table, int64_t n_rows, int W, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ touched, const float* __restrict__ grads,
    int64_t g_stride, const float* __restrict__ shows, int64_t s_stride,
    const float* __restrict__ clks, int64_t c_stride, int64_t n,
    pbt::RowLayout layout) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / pbt::kWarp;
  const int lane = threadIdx.x % pbt::kWarp;
  // every exit below is uniform across the warp (one lane per warp)
  if (i >= n) return;
  const int64_t r = idx[i];
  if (r < 0 || r >= n_rows) return;
  if (touched != nullptr && touched[i] <= 0) return;
  pbt::apply_updates_row<OPT>(table + r * W, W, grads + i * g_stride,
                              shows[i * s_stride], clks[i * c_stride],
                              layout, lane);
}

}  // namespace

extern "C" int pbt_scatter_accumulate(
    float* table, int64_t n_rows, int32_t W, const int32_t* idx,
    const int32_t* touched, const float* grads, int64_t g_stride,
    const float* shows, int64_t s_stride, const float* clks,
    int64_t c_stride, int64_t n, int32_t optimizer,
    const pbt::RowLayout* layout, void* stream) {
  if (n == 0) return 0;
  if (W > pbt::kMaxCols || W < layout->row_width || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps_per_block = kThreads / pbt::kWarp;
  const unsigned blocks =
      static_cast<unsigned>((n + warps_per_block - 1) / warps_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PBT_LAUNCH(OPT)                                                     \
  scatter_accumulate_kernel<OPT><<<blocks, kThreads, 0, st>>>(              \
      table, n_rows, W, idx, touched, grads, g_stride, shows, s_stride,     \
      clks, c_stride, n, *layout)
  switch (optimizer) {
    case pbt::kSgd: PBT_LAUNCH(pbt::kSgd); break;
    case pbt::kAdagrad: PBT_LAUNCH(pbt::kAdagrad); break;
    case pbt::kAdam: PBT_LAUNCH(pbt::kAdam); break;
    case pbt::kFtrl: PBT_LAUNCH(pbt::kFtrl); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PBT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pbt_scatter_accumulate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
