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
// sector per row, since acc rows are gw + 3 floats apart), and each
// touched row reads the rest of its acc row and reads and writes its
// table row; the optimizer's few flops per column are free. What holds a
// kernel back from that bound is latency: a row's update waits on its
// count, and its stores on its loads, so the card needs many rows in
// flight.
//
// Design: a warp owns a run of 32 consecutive rows. Each lane loads one
// row's count, so the warp has 32 independent loads in flight, and
// __ballot_sync names the touched rows. The warp then walks them in
// rounds of 32 / G rows, one row per group of G lanes sized to the row
// width (ops/kernels.py::mu_lane_group), through apply_updates_row: each
// round loads its acc and table rows before any arithmetic, and a group
// left without a row in the last round passes valid = false, so every
// shuffle still names the whole warp. An untouched row costs one lane's
// load and nothing else.
#include <cuda_runtime.h>

#include <cstdint>

#include "apply_updates.cuh"

namespace {

constexpr int kThreads = 256;

// (no __launch_bounds__: with it ptxas spilled the adagrad 8 x 8
// instantiation at 80 registers)
template <int OPT, int G, int CPL>
__global__ void merge_update_kernel(float* table, int64_t n_rows, int W,
                                    const float* __restrict__ acc, int P,
                                    pbt::RowLayout layout) {
  const int lane = threadIdx.x % pbt::kWarp;
  // first row of the warp's run; the exit is uniform across the warp
  const int64_t r0 =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane;
  if (r0 >= n_rows) return;
  const int gw = P - 3;
  const int64_t r = r0 + lane;
  const bool touched = r < n_rows && acc[r * P + gw + 2] > 0.f;
  unsigned rest = __ballot_sync(pbt::kFullMask, touched);
  const int group = lane / G;
  while (rest) {                       // uniform: rest is the warp's
    // this group's row: the group-th touched row still to do
    // (predicated, not a loop of the group's own length: the lanes stay
    // converged for the shuffles)
    unsigned m = rest;
#pragma unroll
    for (int j = 0; j < pbt::kWarp / G - 1; ++j) {
      if (j < group) m &= m - 1;
    }
    const bool valid = m != 0;
    const int64_t row = r0 + (valid ? __ffs(m) - 1 : 0);
    const float* a = acc + row * P;
    pbt::apply_updates_row<OPT, G, CPL>(
        table + row * W, a, valid ? a[gw] : 0.f, valid ? a[gw + 1] : 0.f,
        layout, lane % G, valid);
#pragma unroll
    for (int j = 0; j < pbt::kWarp / G; ++j) rest &= rest - 1;
  }
}

using KernelFn = void (*)(float*, int64_t, int, const float*, int,
                          pbt::RowLayout);

template <int G, int CPL>
KernelFn pick(int optimizer) {
  switch (optimizer) {
    case pbt::kSgd: return merge_update_kernel<pbt::kSgd, G, CPL>;
    case pbt::kAdagrad: return merge_update_kernel<pbt::kAdagrad, G, CPL>;
    case pbt::kAdam: return merge_update_kernel<pbt::kAdam, G, CPL>;
    case pbt::kFtrl: return merge_update_kernel<pbt::kFtrl, G, CPL>;
    default: return nullptr;
  }
}

}  // namespace

// group: lanes per row; cols: columns per lane, as
// ops/kernels.py::mu_lane_group picks them from the row width.
extern "C" int pbt_merge_update(float* table, int64_t n_rows, int32_t W,
                                const float* acc, int32_t P,
                                int32_t optimizer, int32_t group,
                                int32_t cols, const pbt::RowLayout* layout,
                                void* stream) {
  if (n_rows == 0) return 0;
  // P must be grad_width + 3 = embed_w_num + total_dim + 3
  if (W > pbt::kMaxCols || W < layout->row_width || n_rows < 0 ||
      P != layout->embed_w_num + layout->total_dim + 3 ||
      static_cast<int64_t>(group) * cols < layout->row_width)
    return static_cast<int>(cudaErrorInvalidValue);
  KernelFn fn = nullptr;
  if (group == 4 && cols == 4) {
    fn = pick<4, 4>(optimizer);
  } else if (group == 8 && cols == 8) {
    fn = pick<8, 8>(optimizer);
  } else if (group == 16 && cols == 8) {
    fn = pick<16, 8>(optimizer);
  } else if (group == 32 && cols == 8) {
    fn = pick<32, 8>(optimizer);
  } else if (group == 32 && cols == 16) {
    fn = pick<32, 16>(optimizer);
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fn<<<static_cast<unsigned>(blocks), kThreads, 0,
       static_cast<cudaStream_t>(stream)>>>(table, n_rows, W, acc, P,
                                             *layout);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pbt_merge_update_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
