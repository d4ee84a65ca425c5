// Padded-sparse structure2vec kernels for Hopper (sm_90a), over neighbour
// lists nbr (B, Nl, D) int32 with per-slot factors edge (B, Nl, D):
//
//   agg[b,k,i] = sum_d cd(x[b,k,nbr[b,i,d]]) * cd(edge[b,i,d])    (f32 sum)
//   s2v_sparse_aggregate: out = agg
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
// Hopper gathers.  x is read node-major (the wrapper passes a (B, ncols, K)
// or (B, ncols, KP) copy), so one neighbour is one 128-byte line at K = 32.
//
// What bounds it: the work is a gather, 2*K FLOPs per slot against 8 bytes
// of (id, factor) per slot, so it is bound by bytes.  The layer has two
// routes, both one fmaf chain per output in slot order with the same
// theta4 epilogue, so they give the same bits; its wrapper picks one per
// launch from the shapes (kernels/walk.py):
//
// - The row walk (sparse_rows_kernel, shared with s2v_csr.cu through
//   s2v_rows.cuh): one warp owns one node and lane k owns row k.  The
//   warp loads 32 slot ids and factors at once (one coalesced word each
//   per lane), the next 32 are already in flight while the current ones
//   are broadcast with __shfl_sync, and each neighbour is one FMA per
//   lane.  It re-reads x once per slot, mostly from L2 (a 4096-node
//   graph's x is 512 KB): about 2.5 GB of L2 traffic and 50M shuffles per
//   serving bucket, but nothing per block, so it is the route where x is
//   large next to the lists.
// - The windowed walk (s2v_window.cuh, also the aggregate's one route):
//   128 nodes a block, 8 lanes a node, x streamed through 96 KB
//   shared-memory windows once per block, 32-slot chunks whose cursor
//   waits only at an id above the window.  The layer stages cd(agg) per
//   (k, node) in shared memory and runs the theta4 chain there.  It reads
//   x from L2 once per block, so it pays where x is small next to the
//   lists (the serving bucket: 134 MB of windows against 201 MB of lists).
//   Lists of a width that is not a multiple of 4 start inside a 16-byte
//   group: they are read by aligned groups with the slots outside the
//   node's masked, never copied.
#include "s2v_rows.cuh"
#include "s2v_window.cuh"

namespace {

using namespace s2v_rows;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
sparse_rows_kernel(const float* __restrict__ theta4,
                   const float* __restrict__ xt,     // (B, ncols, K)
                   const int* __restrict__ nbr,      // (B, Nl, D)
                   const float* __restrict__ edge,   // (B, Nl, D)
                   const float* __restrict__ base,   // (B, K, Nl)
                   float* __restrict__ out,          // (B, K, Nl)
                   int K, int ncols, int Nl, int D) {
  __shared__ float t4T[32 * 32];
  __shared__ float stage[32][WARPS + 1];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * WARPS, i = i0 + warp;
  load_theta4<BF16>(t4T, theta4, K);
  __syncthreads();

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
  stage[lane][warp] = theta4_product<BF16>(t4T, acc, K, lane);
  __syncthreads();
  store_tile(stage, base, out, b, K, Nl, i0);
}

bool bad_sizes(int B, int K, int ncols, int Nl, int D) {
  return B < 1 || B > 65535 || K < 1 || K > 32 || ncols < 1 || Nl < 1 ||
         D < 1;
}

bool misaligned(const void* xt, const void* ids, const void* w) {
  return (reinterpret_cast<uintptr_t>(xt) | reinterpret_cast<uintptr_t>(ids) |
          reinterpret_cast<uintptr_t>(w)) % 16 != 0;
}

}  // namespace

// The aggregate.  xt (B, N+1, KP): the embeddings node-major with the
// zero sentinel column, each row padded with zeros from K to KP = K rounded
// up to a multiple of 4; nbr and edge (B, Nl, D), any D: the neighbour
// lists of Nl nodes (Nl = N on one device, a row block of a graph split
// over a mesh's graph axis otherwise), with global ids; out
// (B, K, Nl), the f32 sums.  bf16 != 0 rounds x and the factors to bf16 at
// use, as the layer does.  xt, nbr and edge 16-byte aligned.  Returns the
// first CUDA error, if any.
extern "C" int s2v_sparse_aggregate(const float* xt, const int* nbr,
                                    const float* edge, float* out, int B,
                                    int K, int KP, int N, int Nl, int D,
                                    int bf16, void* stream) {
  if (bad_sizes(B, K, N + 1, Nl, D) || KP % 4 != 0 || KP < K || KP > 32 ||
      misaligned(xt, nbr, edge))
    return (int)cudaErrorInvalidValue;
  const s2v_window::Args p{xt, nbr, edge, nullptr, nullptr, nullptr, out,
                           K, KP, N + 1, Nl, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace s2v_window;
  if (D % 4 == 0)
    return (int)(bf16 ? launch<PADDED4, true, false>(p, B, s)
                      : launch<PADDED4, false, false>(p, B, s));
  return (int)(bf16 ? launch<PADDED, true, false>(p, B, s)
                    : launch<PADDED, false, false>(p, B, s));
}

// The layer by the windowed walk.  theta4 (K, K); xt (B, N, KP): the
// embeddings node-major, no sentinel column, each row padded with zeros to
// KP = K rounded up to a multiple of 4; nbr and edge (B, Nl, D), any D;
// base and out (B, K, Nl).  xt, nbr and edge 16-byte aligned.  bf16 != 0
// selects bf16 operand rounding.  Returns the first CUDA error, if any.
extern "C" int s2v_sparse_layer_windowed(const float* theta4,
                                         const float* xt, const int* nbr,
                                         const float* edge, const float* base,
                                         float* out, int B, int K, int KP,
                                         int N, int Nl, int D, int bf16,
                                         void* stream) {
  if (bad_sizes(B, K, N, Nl, D) || KP % 4 != 0 || KP < K || KP > 32 ||
      misaligned(xt, nbr, edge))
    return (int)cudaErrorInvalidValue;
  const s2v_window::Args p{xt, nbr, edge, nullptr, theta4, base, out,
                           K, KP, N, Nl, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D % 4 == 0
      ? s2v_window::launch_layer<s2v_window::PADDED4>(p, B, bf16, s)
      : s2v_window::launch_layer<s2v_window::PADDED>(p, B, bf16, s));
}

// The layer by the row walk.  theta4 (K, K); xt (B, N, K): the embeddings
// node-major, no sentinel column; nbr and edge (B, Nl, D); base and out
// (B, K, Nl).  bf16 != 0 selects bf16 operand rounding.  Returns
// cudaGetLastError().
extern "C" int s2v_sparse_layer(const float* theta4, const float* xt,
                                const int* nbr, const float* edge,
                                const float* base, float* out, int B, int K,
                                int N, int Nl, int D, int bf16, void* stream) {
  if (bad_sizes(B, K, N, Nl, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Nl + WARPS - 1) / WARPS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    sparse_rows_kernel<true><<<grid, THREADS, 0, s>>>(
        theta4, xt, nbr, edge, base, out, K, N, Nl, D);
  else
    sparse_rows_kernel<false><<<grid, THREADS, 0, s>>>(
        theta4, xt, nbr, edge, base, out, K, N, Nl, D);
  return (int)cudaGetLastError();
}
