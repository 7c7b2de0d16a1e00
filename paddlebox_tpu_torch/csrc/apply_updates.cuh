// In-table sparse optimizer update of ONE row by ONE group of G lanes —
// the device translation of paddlebox_tpu_torch/embedding/optim.py::
// apply_updates (itself the port of paddlebox_tpu/embedding/optim.py:
// 44-138).
//
// Row layout (embedding/config.py): col 0 show, col 1 clk, cols
// [2, fixed_cols) the w block, then total_dim embedx(+expand) columns,
// then the optimizer-state columns up to row_width; columns past
// row_width (device-table padding) are never read or written. The grad
// row lines up with the table row shifted by two: table column c in
// [2, fixed_cols + total_dim) takes grad column c - 2.
//
// A group is G neighbouring lanes of one warp (G a power of two, 4 to
// 32); lane l of the group owns table columns l, l + G, ... (CPL of them
// in registers, so G * CPL >= row_width). The per-row scalars (show,
// clk, w, the first grad, the state columns) come from the lanes that
// loaded them, by shuffle; the per-row means the optimizers need (mean
// g_w, mean g_w^2, mean g_x, mean g_x^2) are xor-butterfly sums inside
// the group, whose pairwise adds are commutative, so every lane holds
// bit-identical totals. Each lane stores only the columns it loaded, so
// the update may run in place without a barrier.
//
// Every lane of the warp must call this together (the shuffles name the
// whole warp); a group whose row is a pad passes valid = false and then
// reads and writes nothing.
//
// SCALAR_LOADS (merge_update's one-warp-per-row layout) reads the
// per-row scalars from memory on every lane, ahead of the columns, as
// the first design did, and then needs a __syncwarp before the in-place
// stores; scatter_accumulate takes them by shuffle.
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
constexpr unsigned kFullMask = 0xffffffffu;

// Sum over the group of G lanes; every lane gets the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, o, G);
  }
  return v;
}

// Column c of the group's row (c uniform over the warp), from the lane
// that holds it in its register array.
template <int G, int CPL>
__device__ __forceinline__ float group_col(const float (&v)[CPL], int c) {
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (k == c / G) mine = v[k];
  }
  return __shfl_sync(kFullMask, mine, c % G, G);
}

__device__ __forceinline__ float adagrad_scale(float lr, float g0,
                                               float acc) {
  return lr * sqrtf(g0 / (g0 + acc));
}

// row: the table row, read and written in place; g: the row's
// grad_width grads; show_inc / clk_inc: counter increments; lane: the
// lane's index in its group.
template <int OPT, int G, int CPL, bool SCALAR_LOADS = false>
__device__ __forceinline__ void apply_updates_row(
    float* row, const float* g, float show_inc, float clk_inc,
    const RowLayout& L, int lane, bool valid) {
  const int fc = L.fixed_cols;
  const int nw = L.embed_w_num;
  const int d = L.total_dim;
  const int ob = fc + d;               // first optimizer-state column
  const int rw = L.row_width;
  const int n_state = rw - ob;

  // ---- loads: the per-row scalars (SCALAR_LOADS), then the lane's
  // columns of the row and of the grads
  float show = 0.f, clk = 0.f, w0 = 0.f, g_w0 = 0.f;
  float st0 = 0.f, st1 = 0.f, st2 = 0.f, st3 = 0.f;
  if (SCALAR_LOADS && valid) {
    show = row[0] + show_inc;             // post-increment counters
    clk = row[1] + clk_inc;
    st0 = n_state > 0 ? row[ob] : 0.f;
    st1 = n_state > 1 ? row[ob + 1] : 0.f;
    st2 = n_state > 2 ? row[ob + 2] : 0.f;
    st3 = n_state > 3 ? row[ob + 3] : 0.f;
    w0 = row[2];
    g_w0 = g[0];
  }
  float v[CPL];
  float gr[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + k * G;
    // SCALAR_LOADS (one warp per row, room for 512 columns) stops at
    // the row's width: fully unrolled, the predicated-off columns of a
    // narrow row cost merge_update a third of its time. A group sized
    // to its row runs the unrolled loop faster.
    if (SCALAR_LOADS && k * G >= rw) break;
    v[k] = 0.f;
    gr[k] = 0.f;
    if (valid && c < rw) v[k] = row[c];
    if (valid && c >= 2 && c < ob) gr[k] = g[c - 2];
  }

  if (SCALAR_LOADS) {
    __syncwarp();   // every lane has read its scalars before any store
  } else {
    // the per-row scalars from the lanes that loaded them (the layout is
    // uniform over the warp, so every guard below is too)
    show = group_col<G, CPL>(v, 0) + show_inc;  // post-increment counters
    clk = group_col<G, CPL>(v, 1) + clk_inc;
    w0 = group_col<G, CPL>(v, 2);
    g_w0 = group_col<G, CPL>(gr, 2);            // grad column 0
    st0 = n_state > 0 ? group_col<G, CPL>(v, ob) : 0.f;
    st1 = n_state > 1 ? group_col<G, CPL>(v, ob + 1) : 0.f;
    st2 = n_state > 2 ? group_col<G, CPL>(v, ob + 2) : 0.f;
    st3 = n_state > 3 ? group_col<G, CPL>(v, ob + 3) : 0.f;
  }

  // ---- gating and the lane's partial sums
  float s_gw = 0.f, s_gw2 = 0.f, s_gx = 0.f, s_gx2 = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + k * G;
    if (SCALAR_LOADS && k * G >= rw) break;
    if (c >= 2 && c < ob) {
      float gg = gr[k];
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

  const float mean_gw = group_sum<G>(s_gw) / static_cast<float>(nw);
  const float mean_gw2 = group_sum<G>(s_gw2) / static_cast<float>(nw);
  const float mean_gx = d ? group_sum<G>(s_gx) / static_cast<float>(d) : 0.f;
  const float mean_gx2 =
      d ? group_sum<G>(s_gx2) / static_cast<float>(d) : 0.f;
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

  // ---- stores: each lane writes the columns it loaded
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + k * G;
    if (SCALAR_LOADS && k * G >= rw) break;
    if (c >= rw) continue;                 // padding passes through
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
