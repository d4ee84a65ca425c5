// Padded-sparse structure2vec kernels for Hopper (sm_90a), over neighbour
// lists nbr (B, Nl, D) int32 with per-slot factors edge (B, Nl, D):
//
//   agg[b,k,i] = sum_d cd(x[b,k,nbr[b,i,d]]) * cd(edge[b,i,d])    (f32 sum)
//   s2v_sparse_aggregate: out = agg                                (f32 only)
//   s2v_sparse_layer:     out[b,k,i] = relu(base[b,k,i] + sum_j cd(theta4[k,j]) * cd(agg[b,j,i]))
//
// cd() is the compute-dtype rounding (identity for f32, round to bf16 for
// bf16).  Slot ids outside [0, ncols) add nothing and are never read: for the
// fused layer x has N columns and the padding sentinel N is skipped (x[b,:,N]
// would be the next graph's data); for the aggregate x carries a zero
// sentinel column (ncols = N + 1), so reading it is legal and adds zero.
//
// Replaces: src/repro/kernels/s2v_fused.py::fused_s2v_layer_sparse
// (_fused_sparse_kernel) and src/repro/kernels/s2v_gather.py::
// sparse_mp_aggregate (_sparse_agg_kernel).  The TPU kernels expand each
// node tile's neighbour list into a one-hot (TN, N) matrix in VMEM and
// multiply it on the MXU, because the TPU has no fast gather along lanes.
// Hopper gathers: here one warp owns one node and lane k owns row k.  The
// warp loads 32 slot ids and factors at once (one coalesced word each per
// lane), the next 32 are already in flight while the current ones are
// broadcast with __shfl_sync, and each neighbour is one FMA per lane.
//
// What bounds it: the work is a gather, 2*K FLOPs per slot against 8 bytes
// of (id, factor) per slot, so it is bound by bytes.  x is read node-major
// (the wrapper passes a (B, ncols, K) copy), so one neighbour is one 128-byte
// line at K = 32 instead of 32 separate sectors; x is re-read once per edge,
// mostly from L2 (a 4096-node graph's x is 512 KB).  The (K, Nl) aggregate
// never reaches device memory in the fused layer.
#include "s2v_rows.cuh"

namespace {

using namespace s2v_rows;

template <bool BF16, bool FUSED>
__global__ void __launch_bounds__(THREADS)
sparse_rows_kernel(const float* __restrict__ theta4,
                   const float* __restrict__ xt,     // (B, ncols, K)
                   const int* __restrict__ nbr,      // (B, Nl, D)
                   const float* __restrict__ edge,   // (B, Nl, D)
                   const float* __restrict__ base,   // (B, K, Nl) or null
                   float* __restrict__ out,          // (B, K, Nl)
                   int K, int ncols, int Nl, int D) {
  __shared__ float t4T[FUSED ? 32 * 32 : 1];
  __shared__ float stage[32][WARPS + 1];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * WARPS, i = i0 + warp;
  if (FUSED) {
    load_theta4<BF16>(t4T, theta4, K);
    __syncthreads();
  }

  float acc = 0.f;
  if (i < Nl) {                          // uniform across the warp
    const size_t row = ((size_t)b * Nl + i) * D;
    const float* xb = xt + (size_t)b * ncols * K;
    const bool k_lane = lane < K;
    int id = -1;
    float w = 0.f;
    if (lane < D) {
      id = nbr[row + lane];
      w = edge[row + lane];
    }
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int cur_id = id;
      const float cur_w = w;
      const int dn = d0 + 32 + lane;     // the next 32 slots, in flight
      id = -1;
      w = 0.f;
      if (dn < D) {
        id = nbr[row + dn];
        w = edge[row + dn];
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int j = __shfl_sync(FULL, cur_id, t);
        const float wj = __shfl_sync(FULL, cur_w, t);
        if ((unsigned)j < (unsigned)ncols && k_lane)
          acc = fmaf(round_cd<BF16>(xb[(size_t)j * K + lane]),
                     round_cd<BF16>(wj), acc);
      }
    }
  }
  stage[lane][warp] = FUSED ? theta4_product<BF16>(t4T, acc, K, lane) : acc;
  __syncthreads();
  store_tile(stage, FUSED ? base : nullptr, out, b, K, Nl, i0);
}

bool bad_sizes(int B, int K, int ncols, int Nl, int D) {
  return B < 1 || B > 65535 || K < 1 || K > 32 || ncols < 1 || Nl < 1 ||
         D < 1;
}

}  // namespace

// Kernel 4.  xt (B, N+1, K): the embeddings node-major with the zero
// sentinel column; nbr and edge (B, Nl, D): the neighbour lists of Nl nodes
// (Nl = N on one device, a row block of a graph split over a mesh's graph
// axis otherwise), with global ids; out (B, K, Nl).  f32.  Returns
// cudaGetLastError().
extern "C" int s2v_sparse_aggregate(const float* xt, const int* nbr,
                                    const float* edge, float* out, int B,
                                    int K, int N, int Nl, int D,
                                    void* stream) {
  if (bad_sizes(B, K, N + 1, Nl, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Nl + WARPS - 1) / WARPS, B);
  sparse_rows_kernel<false, false><<<grid, THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      nullptr, xt, nbr, edge, nullptr, out, K, N + 1, Nl, D);
  return (int)cudaGetLastError();
}

// Kernel 3.  theta4 (K, K); xt (B, N, K): the embeddings node-major, no
// sentinel column; nbr and edge (B, Nl, D); base and out (B, K, Nl).
// bf16 != 0 selects bf16 operand rounding.  Returns cudaGetLastError().
extern "C" int s2v_sparse_layer(const float* theta4, const float* xt,
                                const int* nbr, const float* edge,
                                const float* base, float* out, int B, int K,
                                int N, int Nl, int D, int bf16, void* stream) {
  if (bad_sizes(B, K, N, Nl, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Nl + WARPS - 1) / WARPS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    sparse_rows_kernel<true, true><<<grid, THREADS, 0, s>>>(
        theta4, xt, nbr, edge, base, out, K, N, Nl, D);
  else
    sparse_rows_kernel<false, true><<<grid, THREADS, 0, s>>>(
        theta4, xt, nbr, edge, base, out, K, N, Nl, D);
  return (int)cudaGetLastError();
}
