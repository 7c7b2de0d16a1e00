// Row-wise fused merge-apply over premerged unique lanes.
//
// Replaces the TPU kernel paddlebox_tpu/ops/pallas_kernels.py::
// _scatter_accumulate_kernel (wrapper scatter_accumulate). Contract (the
// plain PyTorch statement is ops/kernels.py::scatter_accumulate_plain):
//   table (n_rows, W) f32, W <= 512, updated IN PLACE — the counterpart
//         of the TPU kernel's input_output_aliases: rows that no valid
//         lane names are never read or written and keep their exact bits
//   idx   (n,) int32, one lane per touched row: ids are unique among
//         valid lanes, so no two groups touch one row and no atomics are
//         needed
//   grads (n, grad_width) f32 (row stride given), shows/clks (n,) f32
//         (element strides given) — the merged per-row payload
//   touched (n,) int32 or null; a lane is valid iff 0 <= idx < n_rows
//         and (touched == null or touched > 0). An invalid lane (pad)
//         reads nothing past its id and touched flag and writes nothing,
//         wherever it sits in the lane list, so a pad can never clobber a
//         real row's update.
// Per valid lane: read the row, run apply_updates (apply_updates.cuh),
// write it back.
//
// Bound on an H100: memory. Each valid lane reads and writes one row of
// row_width * 4 bytes at a scattered table location plus its payload,
// and every lane's id is read; the optimizer's few flops per column are
// free. Design: a group of G lanes per row, G chosen at launch from the
// row width (ops/kernels.py::sa_lane_group: 8 lanes up to 64 columns,
// 16 up to 128, 32 beyond), so each lane holds CPL = ceil(W / G) <= 16
// columns in registers and a warp updates 32 / G rows at once: more rows
// in flight per SM, and a pad costs a fraction of a warp. (At W = 37 on
// an H100, 8 lanes beat 16 and 32: PERF.md.) Neighbouring groups take
// neighbouring lanes, which the dedup plan sorts by row, so a warp's
// loads land on nearby rows. The per-row scalars are shuffles
// from the lanes that loaded them and the means are log2(G)-step
// butterflies inside the group, so a row is one read, a few shuffles and
// one write.
#include <cuda_runtime.h>

#include <cstdint>

#include "apply_updates.cuh"

namespace {

constexpr int kThreads = 256;

template <int OPT, int G, int CPL>
__global__ void __launch_bounds__(kThreads) scatter_accumulate_kernel(
    float* table, int64_t n_rows, int W, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ touched, const float* __restrict__ grads,
    int64_t g_stride, const float* __restrict__ shows, int64_t s_stride,
    const float* __restrict__ clks, int64_t c_stride, int64_t n,
    pbt::RowLayout layout) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // a warp past the last lane leaves together; every other warp runs to
  // the end, since the group shuffles name all 32 of its lanes
  if ((t & ~static_cast<int64_t>(pbt::kWarp - 1)) / G >= n) return;
  const int64_t i = t / G;
  const int lane = threadIdx.x % G;
  bool valid = i < n;
  int64_t r = 0;
  if (valid) {
    r = idx[i];
    valid = r >= 0 && r < n_rows && (touched == nullptr || touched[i] > 0);
  }
  const float show_inc = valid ? shows[i * s_stride] : 0.f;
  const float clk_inc = valid ? clks[i * c_stride] : 0.f;
  pbt::apply_updates_row<OPT, G, CPL>(
      table + (valid ? r * W : 0), grads + (valid ? i * g_stride : 0),
      show_inc, clk_inc, layout, lane, valid);
}

using KernelFn = void (*)(float*, int64_t, int, const int32_t*,
                         const int32_t*, const float*, int64_t, const float*,
                         int64_t, const float*, int64_t, int64_t,
                         pbt::RowLayout);

template <int G, int CPL>
cudaError_t launch(int optimizer, cudaStream_t st, float* table,
                   int64_t n_rows, int W, const int32_t* idx,
                   const int32_t* touched, const float* grads,
                   int64_t g_stride, const float* shows, int64_t s_stride,
                   const float* clks, int64_t c_stride, int64_t n,
                   const pbt::RowLayout& layout) {
  KernelFn fn;
  switch (optimizer) {
    case pbt::kSgd: fn = scatter_accumulate_kernel<pbt::kSgd, G, CPL>; break;
    case pbt::kAdagrad:
      fn = scatter_accumulate_kernel<pbt::kAdagrad, G, CPL>;
      break;
    case pbt::kAdam: fn = scatter_accumulate_kernel<pbt::kAdam, G, CPL>; break;
    case pbt::kFtrl: fn = scatter_accumulate_kernel<pbt::kFtrl, G, CPL>; break;
    default: return cudaErrorInvalidValue;
  }
  const int64_t rows_per_block = kThreads / G;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      table, n_rows, W, idx, touched, grads, g_stride, shows, s_stride, clks,
      c_stride, n, layout);
  return cudaGetLastError();
}

}  // namespace

// group: lanes per row (8, 16 or 32); cols: columns per lane (8, or 16
// with 32 lanes), as ops/kernels.py::sa_lane_group picks them.
extern "C" int pbt_scatter_accumulate(
    float* table, int64_t n_rows, int32_t W, const int32_t* idx,
    const int32_t* touched, const float* grads, int64_t g_stride,
    const float* shows, int64_t s_stride, const float* clks,
    int64_t c_stride, int64_t n, int32_t optimizer, int32_t group,
    int32_t cols, const pbt::RowLayout* layout, void* stream) {
  if (n == 0) return 0;
  if (W > pbt::kMaxCols || W < layout->row_width || n_rows <= 0 ||
      n < 0 || static_cast<int64_t>(group) * cols < layout->row_width)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PBT_ARGS                                                            \
  optimizer, st, table, n_rows, W, idx, touched, grads, g_stride, shows,   \
      s_stride, clks, c_stride, n, *layout
  cudaError_t err;
  if (group == 8 && cols == 8) {
    err = launch<8, 8>(PBT_ARGS);
  } else if (group == 16 && cols == 8) {
    err = launch<16, 8>(PBT_ARGS);
  } else if (group == 32 && cols == 8) {
    err = launch<32, 8>(PBT_ARGS);
  } else if (group == 32 && cols == 16) {
    err = launch<32, 16>(PBT_ARGS);
  } else {
    err = cudaErrorInvalidValue;
  }
#undef PBT_ARGS
  return static_cast<int>(err);
}

extern "C" const char* pbt_scatter_accumulate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
