// Shared pieces of the row-parallel structure2vec kernels (s2v_gather.cu,
// s2v_csr.cu): one warp per output node, lane k owns embedding row k
// (K <= 32), WARPS consecutive nodes per block.
//
// Each warp sums its node's neighbours in slot order, one FMA per neighbour
// into its lane's accumulator: the builders list neighbours by ascending id,
// so this is the same chain, in the same order, as s2v_fused.cu's sum over l
// of the dense layer, and the epilogue below repeats that kernel's theta4
// product term for term.  Dense, padded-sparse and CSR layers therefore give
// the same bits for the same graph.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s2v_rows {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;                 // output nodes per block
constexpr int THREADS = 32 * WARPS;

template <bool BF16>
__device__ __forceinline__ float round_cd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// t4T[j * 32 + k] = cd(theta4[k, j]), zero outside K x K: lane k then reads
// consecutive words for each j.
template <bool BF16>
__device__ __forceinline__ void load_theta4(float* t4T, const float* theta4,
                                            int K) {
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) {
    const int j = i / 32, k = i % 32;
    t4T[i] = (j < K && k < K) ? round_cd<BF16>(theta4[k * K + j]) : 0.f;
  }
}

// e3[k] = sum_j cd(theta4[k, j]) * cd(acc_j), one FMA chain over ascending j,
// with acc_j taken from lane j.  Every lane of the warp must call it.
template <bool BF16>
__device__ __forceinline__ float theta4_product(const float* t4T, float acc,
                                                int K, int lane) {
  const float agg = round_cd<BF16>(acc);
  float e3 = 0.f;
  for (int j = 0; j < K; ++j)
    e3 = fmaf(t4T[j * 32 + lane], __shfl_sync(FULL, agg, j), e3);
  return e3;
}

// Writes the block's (K, WARPS) tile of results, staged in shared memory so
// that each k row goes out as WARPS consecutive floats: out[b, k, i0 + w] =
// relu(base[...] + stage[k][w]) when base is given, else stage[k][w].
// Called by every thread of the block.
__device__ __forceinline__ void store_tile(float (*stage)[WARPS + 1],
                                           const float* base, float* out,
                                           int b, int K, int Nout, int i0) {
  for (int t = threadIdx.x; t < 32 * WARPS; t += blockDim.x) {
    const int k = t / WARPS, w = t % WARPS, n = i0 + w;
    if (k < K && n < Nout) {
      const size_t o = ((size_t)b * K + k) * Nout + n;
      out[o] = base ? fmaxf(base[o] + stage[k][w], 0.f) : stage[k][w];
    }
  }
}

}  // namespace s2v_rows
