// Per-row push accumulator from a raw token stream, one super-block of
// table rows per thread block.
//
// Replaces the TPU kernel paddlebox_tpu/ops/pallas_kernels.py::
// _binned_acc_kernel (wrapper binned_merge_acc; the token grouping of
// _bp_pack). Only its contract carries over — the TPU's one-hot bf16-split
// matrix products stand in for a scatter the TPU does slowly, and Hopper
// has fast shared-memory atomics instead. Contract (the plain PyTorch
// statement is ops/kernels.py::binned_merge_acc_plain):
//   acc   (n_rows, P) f32 out, P = gw + 3: row r holds [sum of grads,
//         sum of shows, sum of clks, token count] over the tokens whose
//         id is r, summed in f32; tokens whose id lies outside
//         [0, n_rows) are dropped. Every row is written, so the caller
//         allocates acc with torch.empty.
//   idx   (n,) int32; grads (n, gw) f32 (row stride given); shows, clks
//         (n,) f32 (element strides given)
//   order (n,) int32, or null for the identity (a stream already grouped
//         by row, such as premerged lanes); rstart, end (NB,) int32:
//         block b's tokens are all among order[rstart[b] .. end[b]).
//         rstart may be rounded down (the host plans round to a multiple
//         of 8), so a window can begin with tokens of earlier blocks.
//   SB    rows per super-block; NB = ceil(n_rows / SB), the last block
//         may be ragged.
// The row-range check drops the tokens of other blocks at the head of a
// window and the out-of-range ids that the plans clip into the first or
// last block; nothing is counted twice.
//
// Bound on an H100: memory. The function must read each token's id, its
// order entry and its gw + 2 payload floats once and write the
// (n_rows, P) accumulator once; its n * P adds are nothing beside that.
// Design: a block zeroes an (SB, P) accumulator in shared memory (SB * P
// * 4 <= 96 KB, chosen by ops/kernels.py::binned_geometry), walks its
// token window as (token, column) pairs so neighbouring threads read
// neighbouring payload columns, adds each into shared memory with
// atomicAdd (no global atomics and no separate zeroing pass over device
// memory), and then stores its rows of acc with coalesced writes, so the
// accumulator crosses device memory exactly once. Shared-memory atomics
// sum in an order that changes from run to run: the grad columns agree
// with the plain version to rounding, while the show, clk and count
// columns are sums of small integers and come out exact.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;

__global__ void binned_merge_acc_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ grads,
    int64_t g_stride, const float* __restrict__ shows, int64_t s_stride,
    const float* __restrict__ clks, int64_t c_stride,
    const int32_t* __restrict__ order, const int32_t* __restrict__ rstart,
    const int32_t* __restrict__ end, int64_t n_rows, int32_t SB, int32_t gw,
    float* __restrict__ acc) {
  extern __shared__ float sacc[];
  const int P = gw + 3;
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * SB;
  const int64_t rows = n_rows - row0 < SB ? n_rows - row0 : SB;
  const int64_t n_sh = rows * P;
  for (int64_t i = threadIdx.x; i < n_sh; i += blockDim.x) sacc[i] = 0.f;
  __syncthreads();

  const int64_t t0 = rstart[b];
  const int64_t work = (static_cast<int64_t>(end[b]) - t0) * P;
  for (int64_t i = threadIdx.x; i < work; i += blockDim.x) {
    const int64_t p = t0 + i / P;
    const int j = static_cast<int>(i % P);
    const int64_t tok = order != nullptr ? order[p] : p;
    const int64_t local = static_cast<int64_t>(idx[tok]) - row0;
    if (local < 0 || local >= rows) continue;
    float v;
    if (j < gw) {
      v = grads[tok * g_stride + j];
    } else if (j == gw) {
      v = shows[tok * s_stride];
    } else if (j == gw + 1) {
      v = clks[tok * c_stride];
    } else {
      v = 1.f;
    }
    atomicAdd(&sacc[local * P + j], v);
  }
  __syncthreads();

  float* out = acc + row0 * P;
  for (int64_t i = threadIdx.x; i < n_sh; i += blockDim.x) out[i] = sacc[i];
}

}  // namespace

extern "C" int pbt_binned_merge_acc(
    const int32_t* idx, const float* grads, int64_t g_stride,
    const float* shows, int64_t s_stride, const float* clks,
    int64_t c_stride, const int32_t* order, const int32_t* rstart,
    const int32_t* end, int64_t n_rows, int32_t SB, int32_t gw, float* acc,
    void* stream) {
  if (n_rows == 0) return 0;
  if (n_rows < 0 || SB <= 0 || gw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_blocks = (n_rows + SB - 1) / SB;
  const int64_t smem = static_cast<int64_t>(SB) * (gw + 3) * 4;
  if (n_blocks > INT_MAX || smem > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    // above 48 KB a block gets dynamic shared memory only on request
    cudaError_t err = cudaFuncSetAttribute(
        binned_merge_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  binned_merge_acc_kernel<<<static_cast<unsigned>(n_blocks), kThreads,
                            static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      idx, grads, g_stride, shows, s_stride, clks, c_stride, order, rstart,
      end, n_rows, SB, gw, acc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pbt_binned_merge_acc_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
