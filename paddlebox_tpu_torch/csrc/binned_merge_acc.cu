// Per-row push accumulator from a raw token stream: one super-block of
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
// Design:
// - Threads run over tokens, not (token, column) items. A warp takes 32
//   tokens per batch, one per lane, and two batches at a time: each lane
//   loads its tokens' order and id entries once (coalesced), and a
//   token's row in the block is one subtraction (no division in the
//   loop).
// - Duplicate rows merge in the warp before any atomic: when
//   __match_any_sync finds a row twice in a batch, a bitonic shuffle sort
//   puts the batch in row order. Then the warp turns: each half of 16
//   lanes walks 16 of the tokens with its lanes over the payload's
//   columns, so a token's payload is one coalesced load per array, all 16
//   tokens' loads are in flight before the first add, and a run of one
//   row sums in registers and costs one shared-memory atomic per column:
//   a hot row costs at most two atomics per warp per column.
// - A super-block's rows live in shared memory, zeroed there, so no pass
//   zeroes acc in device memory; after the barrier the block writes its
//   rows of acc once, with coalesced 16-byte stores.
// - A window a hot row makes long stays on one block. Splitting it over a
//   thread-block cluster (each CTA owning part of the rows, remote adds
//   through distributed shared memory) evened the streams out on an H100
//   but was slower in absolute time on every stream, the hot row's
//   included (PERF.md), so the kernel keeps one block per window.
// Shared-memory atomics add in an order that changes from run to run:
// the grad columns agree with the plain version to rounding, while the
// show, clk and count columns are sums of small integers and come out
// exact.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBlockThreads = 512;  // threads per super-block
constexpr int kBatches = 2;       // 32-token batches per warp in flight
constexpr int kHalf = 16;         // lanes over columns per token
constexpr unsigned kFull = 0xffffffffu;

// Sort the warp's (key, tok) pairs by key, ascending (bitonic network).
__device__ __forceinline__ void warp_sort(int& key, int& tok, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int pk = __shfl_xor_sync(kFull, key, j);
      const int pt = __shfl_xor_sync(kFull, tok, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_min ? pk < key : pk > key) {
        key = pk;
        tok = pt;
      }
    }
  }
}

// Walk one sorted-or-distinct batch of 32 tokens (key, tok per lane):
// half h takes tokens h*16 .. h*16+15 with its lanes over the payload's
// columns; a run of one row sums in registers and costs one atomic.
template <typename Add>
__device__ __forceinline__ void walk_batch(
    int key, int tok, int lane, int P, int gw,
    const float* __restrict__ grads, int g_stride,
    const float* __restrict__ shows, int s_stride,
    const float* __restrict__ clks, int c_stride, const Add& add) {
  const int src0 = (lane / kHalf) * kHalf;
  for (int c0 = 0; c0 < P; c0 += kHalf) {
    const int j = c0 + lane % kHalf;      // the lane's payload column
    const bool on = j < P;
    float x[kHalf];
    int kk[kHalf];
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      kk[s] = __shfl_sync(kFull, key, src0 + s);
      const int64_t t = __shfl_sync(kFull, tok, src0 + s);
      float v = 0.f;
      if (kk[s] >= 0 && on) {
        if (j < gw) {
          v = grads[t * g_stride + j];
        } else if (j == gw) {
          v = shows[t * s_stride];
        } else if (j == gw + 1) {
          v = clks[t * c_stride];
        } else {
          v = 1.f;                        // the token count
        }
      }
      x[s] = v;
    }
    int cur = kk[0];
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      if (kk[s] != cur) {
        if (cur >= 0 && on) add(cur, j, sum);
        cur = kk[s];
        sum = 0.f;
      }
      sum += x[s];
    }
    if (cur >= 0 && on) add(cur, j, sum);
  }
}

__global__ void __launch_bounds__(kBlockThreads) binned_merge_acc_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ grads,
    int g_stride, const float* __restrict__ shows, int s_stride,
    const float* __restrict__ clks, int c_stride,
    const int32_t* __restrict__ order, const int32_t* __restrict__ rstart,
    const int32_t* __restrict__ end, int n_rows, int SB, int gw,
    float* __restrict__ acc) {
  extern __shared__ float4 sacc4[];               // (rows, P)
  float* sacc = reinterpret_cast<float*>(sacc4);
  const int b = blockIdx.x;
  const int P = gw + 3;
  const int row0 = b * SB;
  const int rows = min(n_rows - row0, SB);         // rows of the block
  const int n_sh = rows * P;
  // the block's offset in acc is a multiple of 4 floats when SB is
  const bool vec = (SB & 3) == 0;
  const int n_sh4 = vec ? n_sh / 4 : 0;
  for (int i = threadIdx.x; i < n_sh4; i += kBlockThreads) {
    sacc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = n_sh4 * 4 + threadIdx.x; i < n_sh; i += kBlockThreads) {
    sacc[i] = 0.f;
  }
  __syncthreads();

  const int lo = rstart[b];
  const int hi = end[b];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // add v at column j of block row r
  auto add = [=](int r, int j, float v) { atomicAdd(sacc + r * P + j, v); };
  // the bounds are uniform over the warp, so all its lanes iterate
  // together (the shuffles name all 32)
  for (int base = lo + warp * 32 * kBatches; base < hi;
       base += kBlockThreads * kBatches) {
    // one token per lane and batch: its order and id entries, its row in
    // the block (all batches' loads in flight together)
    int tok[kBatches];
    int key[kBatches];
#pragma unroll
    for (int u = 0; u < kBatches; ++u) {
      const int p = base + u * 32 + lane;
      tok[u] = 0;
      if (p < hi) tok[u] = order != nullptr ? order[p] : p;
    }
#pragma unroll
    for (int u = 0; u < kBatches; ++u) {
      const int p = base + u * 32 + lane;
      key[u] = INT_MIN | lane;     // distinct negative: nothing to add
      if (p < hi) {
        // 64-bit difference: an id far below row0 must not wrap into
        // the block
        const int64_t d = static_cast<int64_t>(idx[tok[u]]) - row0;
        if (d >= 0 && d < rows) key[u] = static_cast<int>(d);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatches; ++u) {
      // a row in the batch twice or more: sort, so each row's tokens sit
      // next to each other in the walk
      const unsigned peers = __match_any_sync(kFull, key[u]);
      if (!__all_sync(kFull, __popc(peers) == 1)) {
        warp_sort(key[u], tok[u], lane);
      }
      walk_batch(key[u], tok[u], lane, P, gw, grads, g_stride, shows,
                 s_stride, clks, c_stride, add);
    }
  }
  __syncthreads();

  const int64_t off = static_cast<int64_t>(row0) * P;
  float4* out4 = reinterpret_cast<float4*>(acc + off);
  // plain (write-back) stores: merge_update reads acc next, from L2
  for (int i = threadIdx.x; i < n_sh4; i += kBlockThreads) out4[i] = sacc4[i];
  for (int i = n_sh4 * 4 + threadIdx.x; i < n_sh; i += kBlockThreads) {
    acc[off + i] = sacc[i];
  }
}

}  // namespace

// acc must be 16-byte aligned (torch's allocations are).
extern "C" int pbt_binned_merge_acc(
    const int32_t* idx, const float* grads, int64_t g_stride,
    const float* shows, int64_t s_stride, const float* clks,
    int64_t c_stride, const int32_t* order, const int32_t* rstart,
    const int32_t* end, int64_t n_rows, int32_t SB, int32_t gw, float* acc,
    void* stream) {
  if (n_rows == 0) return 0;
  if (n_rows < 0 || n_rows > INT_MAX || SB <= 0 || gw < 0 ||
      (reinterpret_cast<uintptr_t>(acc) & 15) != 0 || g_stride < 0 ||
      g_stride > INT_MAX || s_stride < 0 || s_stride > INT_MAX ||
      c_stride < 0 || c_stride > INT_MAX)
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
  binned_merge_acc_kernel<<<static_cast<unsigned>(n_blocks), kBlockThreads,
                            static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      idx, grads, static_cast<int>(g_stride), shows,
      static_cast<int>(s_stride), clks, static_cast<int>(c_stride), order,
      rstart, end, static_cast<int>(n_rows), SB, gw, acc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pbt_binned_merge_acc_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
