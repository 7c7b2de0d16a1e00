// Fused gather + per-(example, slot) sum pool over the device table.
//
// Replaces the TPU kernel paddlebox_tpu/ops/pallas_kernels.py::
// _gather_pool_kernel (wrapper gather_pool). Contract (the plain PyTorch
// statement is ops/kernels.py::gather_pool_plain):
//   table (n_rows, W) f32, row 0 all zeros (masked tokens point there)
//   idx   (B, S*L) int32, token (b, s, l) at column s*L + l; ids clamp
//         into [0, n_rows)
//   out   (B, S, P) f32 = sum over l of the filtered row's first P cols
// Filters, applied per token before pooling with the reference's exact
// comparisons: need_filter keeps a token when
// (show - clk) * show_coeff + clk * clk_coeff >= thr[s]; embed_threshold
// drops it when show > t && |w| < t (w at column cvm_offset); quant_ratio
// rounds the columns past cvm_offset (round half to even). A filtered
// token contributes x * 0, as the reference's multiply by the keep mask.
//
// Bound on an H100: memory. Per output row the kernel reads L rows of
// ~W*4 bytes from random table locations and writes P*4 bytes; there is
// no reuse to exploit except repeated ids, which the L2 cache catches.
// Design: one warp per (example, slot) output row; lanes stride over the
// P columns, so each token's row is one coalesced read, the L tokens are
// summed in order l = 0..L-1 in registers, and the (B, S, P) result is
// written once — the (B*S*L, P) token matrix never exists. Columns go in
// chunks of 512 (16 registers per lane), so any width works.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kColsPerLane = 16;
constexpr int kChunk = kWarp * kColsPerLane;
constexpr int kThreads = 256;

__global__ void gather_pool_kernel(
    const float* __restrict__ table, int64_t n_rows, int W,
    const int32_t* __restrict__ idx, int64_t BS, int S, int L, int P,
    const float* __restrict__ thr, int need_filter, float show_coeff,
    float clk_coeff, float embed_threshold, int quant_ratio, int cvm_offset,
    float* __restrict__ out) {
  const int64_t o = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / kWarp;        // output row = b * S + s
  const int lane = threadIdx.x % kWarp;
  if (o >= BS) return;
  const int s = static_cast<int>(o % S);
  const int32_t* ids = idx + o * L;               // (b, s*L .. s*L + L)
  const bool has_keep = need_filter || embed_threshold > 0.f;
  const float qr = static_cast<float>(quant_ratio);
  for (int c0 = 0; c0 < P; c0 += kChunk) {
    float acc[kColsPerLane];
    for (int l = 0; l < L; ++l) {
      int64_t r = ids[l];
      r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
      const float* src = table + r * W;
      float keep = 1.f;
      if (need_filter) {
        const float show = src[0], clk = src[1];
        keep = ((show - clk) * show_coeff + clk * clk_coeff >= thr[s])
            ? 1.f : 0.f;
      }
      if (embed_threshold > 0.f) {
        const float show = src[0], w = src[cvm_offset];
        if (show > embed_threshold && fabsf(w) < embed_threshold) keep = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int c = c0 + lane + k * kWarp;
        if (c >= P) continue;
        float x = src[c];
        if (quant_ratio > 0 && c >= cvm_offset + 1) x = rintf(x * qr) / qr;
        if (has_keep) x = x * keep;
        acc[k] = l == 0 ? x : acc[k] + x;
      }
    }
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = c0 + lane + k * kWarp;
      if (c < P) out[o * P + c] = acc[k];
    }
  }
}

}  // namespace

extern "C" int pbt_gather_pool(const float* table, int64_t n_rows, int32_t W,
                               const int32_t* idx, int32_t B, int32_t S,
                               int32_t L, int32_t P, const float* thr,
                               int32_t need_filter, float show_coeff,
                               float clk_coeff, float embed_threshold,
                               int32_t quant_ratio, int32_t cvm_offset,
                               float* out, void* stream) {
  const int64_t BS = static_cast<int64_t>(B) * S;
  if (BS == 0 || P == 0) return 0;
  if (L <= 0 || n_rows <= 0 || P > W || cvm_offset < 0 || cvm_offset >= W)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps_per_block = kThreads / kWarp;
  const int64_t blocks = (BS + warps_per_block - 1) / warps_per_block;
  gather_pool_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      table, n_rows, W, idx, BS, S, L, P, thr, need_filter, show_coeff,
      clk_coeff, embed_threshold, quant_ratio, cvm_offset, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pbt_gather_pool_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
