// Masked in-table optimizer pass over the whole table.
//
// Replaces the TPU kernel paddlebox_tpu/ops/pallas_kernels.py::
// _merge_update_kernel (wrapper merge_update). Contract (the plain
// PyTorch statement is ops/kernels.py::merge_update_plain):
//   table (n_rows, W) f32, W <= 512, updated IN PLACE — the JAX kernel
//         returns a new table; here a row whose touch count is not > 0
//         is never read or written and keeps its exact bits
//   acc   (n_rows, gw + 3) f32, contiguous: per row [summed grads (gw),
//         show, clk, touch count] — the output of binned_merge_acc or of
//         the xla_scatter engine's index_add_
// Per touched row: apply_updates (apply_updates.cuh) with the acc row's
// grads and its show/clk increments.
//
// Bound on an H100: memory. Every row's touch count is read (one 32-byte
// sector per row, since rows are gw + 3 floats apart), and each touched
// row reads its acc row and reads and writes its W*4-byte table row; the
// optimizer's few flops per column are free. Design: one warp per row (a
// lane group of G = 32 in apply_updates.cuh, 16 columns per lane), so a
// touched row is one coalesced read and one coalesced write and its means
// are warp shuffles; an untouched row costs its warp one broadcast load
// and nothing else. (The first design, kept: its per-row scalars are
// broadcast loads, SCALAR_LOADS in apply_updates.cuh.)
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "apply_updates.cuh"

namespace {

constexpr int kThreads = 256;

template <int OPT>
__global__ void merge_update_kernel(float* table, int64_t n_rows, int W,
                                    const float* __restrict__ acc, int P,
                                    pbt::RowLayout layout) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / pbt::kWarp;
  const int lane = threadIdx.x % pbt::kWarp;
  // every exit below is uniform across the warp (one row per warp)
  if (r >= n_rows) return;
  const float* a = acc + r * P;
  const int gw = P - 3;
  if (!(a[gw + 2] > 0.f)) return;
  pbt::apply_updates_row<OPT, pbt::kWarp, pbt::kMaxCols / pbt::kWarp,
                         true>(table + r * W, a, a[gw], a[gw + 1], layout,
                               lane, true);
}

}  // namespace

extern "C" int pbt_merge_update(float* table, int64_t n_rows, int32_t W,
                                const float* acc, int32_t P,
                                int32_t optimizer,
                                const pbt::RowLayout* layout, void* stream) {
  if (n_rows == 0) return 0;
  // P must be grad_width + 3 = embed_w_num + total_dim + 3
  if (W > pbt::kMaxCols || W < layout->row_width || n_rows < 0 ||
      P != layout->embed_w_num + layout->total_dim + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows_per_block = kThreads / pbt::kWarp;
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PBT_LAUNCH(OPT)                                                     \
  merge_update_kernel<OPT><<<static_cast<unsigned>(blocks), kThreads, 0,    \
                             st>>>(table, n_rows, W, acc, P, *layout)
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

extern "C" const char* pbt_merge_update_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
