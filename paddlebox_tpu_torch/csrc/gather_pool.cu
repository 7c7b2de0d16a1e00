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
// ~P*4 bytes from random table locations and writes P*4 bytes; there is
// no reuse to exploit except repeated ids, which the L2 cache catches.
// What holds a kernel back from that bound is latency: each token's row
// load waits on its id load, so the card needs many rows in flight.
//
// Design: a group of G lanes per (example, slot) output row, G and the
// columns per lane CPL chosen from P (ops/kernels.py::gp_lane_group: 8
// lanes up to 64 columns, so a warp pools 4 outputs; 16 up to 128; 32
// beyond, in chunks of 512 columns). Lane j of a group loads token j's id
// (kTok tokens at a time) and, under a filter, that token's show, clk and
// w; the ids and keep flags reach the group by shuffle. The group then
// issues every token's row loads before the first add, and the adds run
// in order l = 0..L-1, so the output is bit-equal to the plain version.
// A token whose clamped id is 0 loads nothing and contributes +0.0 (row 0
// is all zeros), so pads cost no memory traffic. The column loop stops
// at P.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kTok = 4;           // tokens a group has in flight
constexpr unsigned kFullMask = 0xffffffffu;

template <int G, int CPL>
__global__ void __launch_bounds__(kThreads) gather_pool_kernel(
    const float* __restrict__ table, int64_t n_rows, int W,
    const int32_t* __restrict__ idx, int64_t BS, int S, int L, int P,
    const float* __restrict__ thr, int need_filter, float show_coeff,
    float clk_coeff, float embed_threshold, int quant_ratio, int cvm_offset,
    float* __restrict__ out) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // a warp past the last output row leaves together; every other warp
  // runs to the end, since the group shuffles name all 32 of its lanes
  if ((t & ~static_cast<int64_t>(kWarp - 1)) / G >= BS) return;
  const int64_t o = t / G;                        // output row b * S + s
  const int lane = threadIdx.x % G;
  const bool live = o < BS;
  const bool has_keep = need_filter || embed_threshold > 0.f;
  const float th = live && need_filter ? thr[o % S] : 0.f;
  const float qr = static_cast<float>(quant_ratio);
  for (int c0 = 0; c0 < P; c0 += G * CPL) {
    float acc[CPL] = {};   // each column takes token 0's value first
    for (int l0 = 0; l0 < L; l0 += kTok) {
      // lane j < kTok: token l0 + j's clamped id and keep flag
      int32_t mine = 0;
      float show = 0.f, clk = 0.f, w = 0.f;
      if (live && lane < kTok && l0 + lane < L) {
        const int64_t r = idx[o * L + l0 + lane];
        mine = static_cast<int32_t>(r < 0 ? 0 : (r >= n_rows ? n_rows - 1
                                                               : r));
        if (has_keep && mine != 0) {
          const float* src = table + static_cast<int64_t>(mine) * W;
          show = __ldg(src);
          clk = __ldg(src + 1);
          w = __ldg(src + cvm_offset);
        }
      }
      int32_t rows[kTok];
#pragma unroll
      for (int j = 0; j < kTok; ++j) {
        rows[j] = __shfl_sync(kFullMask, mine, j, G);
      }
      // every token's row loads before the first add
      float x[kTok][CPL];
#pragma unroll
      for (int j = 0; j < kTok; ++j) {
        const float* src = table + static_cast<int64_t>(rows[j]) * W;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = c0 + lane + k * G;
          x[j][k] = rows[j] != 0 && c < P ? __ldg(src + c) : 0.f;
        }
      }
      float keep = 1.f;
      if (need_filter)
        keep = (show - clk) * show_coeff + clk * clk_coeff >= th ? 1.f : 0.f;
      if (embed_threshold > 0.f && show > embed_threshold &&
          fabsf(w) < embed_threshold)
        keep = 0.f;
#pragma unroll
      for (int j = 0; j < kTok; ++j) {
        const float kj = __shfl_sync(kFullMask, keep, j, G);
        if (l0 + j >= L) break;                   // uniform over the warp
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = c0 + lane + k * G;
          float v = x[j][k];
          if (quant_ratio > 0 && c >= cvm_offset + 1)
            v = rintf(v * qr) / qr;
          if (has_keep) v = v * kj;
          acc[k] = l0 + j == 0 ? v : acc[k] + v;
        }
      }
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = c0 + lane + k * G;
        if (c < P) out[o * P + c] = acc[k];
      }
    }
  }
}

using KernelFn = void (*)(const float*, int64_t, int, const int32_t*,
                          int64_t, int, int, int, const float*, int, float,
                          float, float, int, int, float*);

// the instantiation for `cols` columns a lane in [LO, HI], or null
template <int G, int HI, int LO>
KernelFn kernel_for(int cols) {
  if constexpr (HI < LO) {
    return nullptr;
  } else {
    if (cols == HI) return gather_pool_kernel<G, HI>;
    return kernel_for<G, HI - 1, LO>(cols);
  }
}

}  // namespace

// group: lanes per output row; cols: columns per lane, as
// ops/kernels.py::gp_lane_group picks them from P (group 8 with 1 to 8
// columns, 16 with 5 to 8, 32 with 5 to 16).
extern "C" int pbt_gather_pool(const float* table, int64_t n_rows, int32_t W,
                               const int32_t* idx, int32_t B, int32_t S,
                               int32_t L, int32_t P, const float* thr,
                               int32_t need_filter, float show_coeff,
                               float clk_coeff, float embed_threshold,
                               int32_t quant_ratio, int32_t cvm_offset,
                               int32_t group, int32_t cols, float* out,
                               void* stream) {
  const int64_t BS = static_cast<int64_t>(B) * S;
  if (BS == 0 || P == 0) return 0;
  if (L <= 0 || n_rows <= 0 || P > W || cvm_offset < 0 || cvm_offset >= W)
    return static_cast<int>(cudaErrorInvalidValue);
  KernelFn fn = nullptr;
  if (group == 8) {
    fn = kernel_for<8, 8, 1>(cols);
  } else if (group == 16) {
    fn = kernel_for<16, 8, 5>(cols);
  } else if (group == 32) {
    fn = kernel_for<32, 16, 5>(cols);
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (BS * group + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fn<<<static_cast<unsigned>(blocks), kThreads, 0,
       static_cast<cudaStream_t>(stream)>>>(
      table, n_rows, W, idx, BS, S, L, P, thr, need_filter, show_coeff,
      clk_coeff, embed_threshold, quant_ratio, cvm_offset, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pbt_gather_pool_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
