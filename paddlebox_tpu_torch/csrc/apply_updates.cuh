// In-table sparse optimizer update of ONE row by ONE warp — the device
// translation of paddlebox_tpu_torch/embedding/optim.py::apply_updates
// (itself the port of paddlebox_tpu/embedding/optim.py:44-138).
//
// Row layout (embedding/config.py): col 0 show, col 1 clk, cols
// [2, fixed_cols) the w block, then total_dim embedx(+expand) columns,
// then the optimizer-state columns up to row_width; columns past
// row_width (device-table padding) pass through untouched. The grad row
// lines up with the table row shifted by two: table column c in
// [2, fixed_cols + total_dim) takes grad column c - 2.
//
// Lane l of the warp owns table columns l, l + 32, ... (at most 512
// columns, 16 per lane). The per-row means the optimizers need
// (mean g_w, mean g_w^2, mean g_x, mean g_x^2) are warp reductions; the
// reduced value is broadcast from lane 0 so every lane applies the
// bit-identical scale. Every per-row scalar is read by all lanes before
// the first store (__syncwarp between), so the update may run in place.
//
// Floating point: compile with --fmad=false. The reference computes each
// product and sum as its own rounded f32 operation; a contracted fma
// would round differently.
#pragma once

#include <cstdint>

namespace pbt {

// Mirrors ops/kernels.py::RowLayout (a ctypes.Structure): keep the field
// order and types in step.
struct RowLayout {
  int32_t fixed_cols;       // 2 + embed_w_num
  int32_t embed_w_num;
  int32_t dim;              // embedx plane; [dim, total_dim) is expand
  int32_t total_dim;
  int32_t row_width;        // logical columns, optimizer state included
  float lr;
  float initial_g2sum;
  float beta1;
  float beta2;
  float one_minus_beta1;    // (1 - beta1) rounded once from double, as
  float one_minus_beta2;    // the reference's Python constant is
  float ftrl_l1;
  float ftrl_l2;
  float ftrl_beta;
  float mf_create_threshold;
  float expand_create_threshold;
};

enum Optimizer : int32_t { kSgd = 0, kAdagrad = 1, kAdam = 2, kFtrl = 3 };

constexpr int kWarp = 32;
constexpr int kMaxCols = 512;
constexpr int kColsPerLane = kMaxCols / kWarp;

// Sum over the warp, then lane 0's total to every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ float adagrad_scale(float lr, float g0,
                                               float acc) {
  return lr * sqrtf(g0 / (g0 + acc));
}

// row: W columns, read and written in place; g: the row's grad_width
// grads; show_inc / clk_inc: counter increments. All 32 lanes of the warp
// must call this together.
template <int OPT>
__device__ __forceinline__ void apply_updates_row(
    float* row, int W, const float* g, float show_inc, float clk_inc,
    const RowLayout& L, int lane) {
  const int fc = L.fixed_cols;
  const int nw = L.embed_w_num;
  const int d = L.total_dim;
  const int ob = fc + d;               // first optimizer-state column
  const int n_state = L.row_width - ob;

  // ---- loads: per-row scalars (every lane), then the lane's columns
  const float show = row[0] + show_inc;     // post-increment counters
  const float clk = row[1] + clk_inc;
  const float st0 = n_state > 0 ? row[ob] : 0.f;
  const float st1 = n_state > 1 ? row[ob + 1] : 0.f;
  const float st2 = n_state > 2 ? row[ob + 2] : 0.f;
  const float st3 = n_state > 3 ? row[ob + 3] : 0.f;
  const float w0 = row[2];
  const float g_w0 = g[0];

  float v[kColsPerLane];
  float gr[kColsPerLane];
  float s_gw = 0.f, s_gw2 = 0.f, s_gx = 0.f, s_gx2 = 0.f;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = lane + k * kWarp;
    v[k] = 0.f;
    gr[k] = 0.f;
    if (c < W) v[k] = row[c];
    if (c >= 2 && c < ob) {
      float gg = g[c - 2];
      if (c >= fc) {
        // Variable/NNCross gating on the post-increment show
        const int xk = c - fc;
        if (xk < L.dim) {
          if (L.mf_create_threshold > 0.f && !(show >= L.mf_create_threshold))
            gg = 0.f;
        } else if (L.expand_create_threshold > 0.f &&
                   !(show >= L.expand_create_threshold)) {
          gg = 0.f;
        }
        s_gx += gg;
        s_gx2 += gg * gg;
      } else {
        s_gw += gg;
        s_gw2 += gg * gg;
      }
      gr[k] = gg;
    }
  }
  __syncwarp();

  const float mean_gw = warp_sum(s_gw) / static_cast<float>(nw);
  const float mean_gw2 = warp_sum(s_gw2) / static_cast<float>(nw);
  const float mean_gx = d ? warp_sum(s_gx) / static_cast<float>(d) : 0.f;
  const float mean_gx2 = d ? warp_sum(s_gx2) / static_cast<float>(d) : 0.f;
  const float lr = L.lr;

  // ---- per-row optimizer scalars
  float ns0 = st0, ns1 = st1, ns2 = st2, ns3 = st3;
  float scale_w = lr, scale_x = lr;        // sgd
  float den_w = 1.f, den_x = 1.f;          // adam
  float ftrl_w = 0.f;
  if (OPT == kAdagrad) {
    ns0 = st0 + mean_gw2;
    ns1 = st1 + mean_gx2;
    scale_w = adagrad_scale(lr, L.initial_g2sum, ns0);
    scale_x = adagrad_scale(lr, L.initial_g2sum, ns1);
  } else if (OPT == kAdam) {
    ns0 = L.beta1 * st0 + L.one_minus_beta1 * mean_gw;
    ns1 = L.beta2 * st1 + L.one_minus_beta2 * mean_gw2;
    ns2 = L.beta1 * st2 + L.one_minus_beta1 * mean_gx;
    ns3 = L.beta2 * st3 + L.one_minus_beta2 * mean_gx2;
    den_w = sqrtf(ns1) + 1e-8f;
    den_x = sqrtf(ns3) + 1e-8f;
  } else if (OPT == kFtrl) {
    // FTRL-proximal on the scalar w (ops/ftrl.py), adagrad on embedx
    const float z = st0, n = st1;
    const float new_n = n + g_w0 * g_w0;
    const float sigma = (sqrtf(new_n) - sqrtf(n)) / lr;
    const float new_z = z + g_w0 - sigma * w0;
    const float shrink = fmaxf(fabsf(new_z) - L.ftrl_l1, 0.f);
    const float sgn = new_z > 0.f ? 1.f : (new_z < 0.f ? -1.f : 0.f);
    ftrl_w = (-sgn * shrink) / ((L.ftrl_beta + sqrtf(new_n)) / lr + L.ftrl_l2);
    ns0 = new_z;
    ns1 = new_n;
    ns2 = st2 + mean_gx2;
    scale_x = adagrad_scale(lr, L.initial_g2sum, ns2);
  }

  // ---- stores: each lane writes its own columns
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = lane + k * kWarp;
    if (c >= L.row_width) continue;        // padding passes through
    float out;
    if (c == 0) {
      out = show;
    } else if (c == 1) {
      out = clk;
    } else if (c < fc) {                   // w block
      if (OPT == kAdam) {
        const float w_dir = nw == 1 ? ns0
            : L.beta1 * ns0 + L.one_minus_beta1 * gr[k];
        out = v[k] - (lr * w_dir) / den_w;
      } else if (OPT == kFtrl) {
        out = ftrl_w;
      } else {
        out = v[k] - scale_w * gr[k];
      }
    } else if (c < ob) {                   // embedx (+expand)
      if (OPT == kAdam) {
        out = v[k] - (lr * (L.beta1 * ns2 + L.one_minus_beta1 * gr[k])) /
                         den_x;
      } else {
        out = v[k] - scale_x * gr[k];
      }
    } else {                               // optimizer state
      if (OPT == kSgd) continue;
      const int j = c - ob;
      out = j == 0 ? ns0 : (j == 1 ? ns1 : (j == 2 ? ns2 : ns3));
    }
    row[c] = out;
  }
}

}  // namespace pbt
