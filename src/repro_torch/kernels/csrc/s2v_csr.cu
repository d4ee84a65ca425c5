// CSR structure2vec layer for Hopper (sm_90a), over flat edge arrays
// indptr (B, N+1), indices (B, E) int32 and per-edge factors edge_w (B, E):
//
//   agg[b,k,i] = sum_{e in [indptr[b,i], indptr[b,i+1])} p(x[b,k,indices[b,e]], edge_w[b,e])
//   out[b,k,i] = relu(base[b,k,i] + sum_j cd(theta4[k,j]) * cd(agg[b,j,i]))
//
// with p(x, w) = fmaf into the f32 sum at f32, and the bf16 product
// cd(cd(x) * cd(w)) added in f32 at bf16 (the composition rounds x*w to bf16
// before its f32 segment-sum).  s2v_csr_aggregate (the windowed walk) and
// s2v_csr_aggregate_rows (the row walk) write agg itself: the train step's
// backward of the layer recomputes agg and, for the symmetric graphs the env
// builds, forms the input's gradient as one more aggregate
// (core/s2v_csr.py).  Column ids outside [0, N), the padding
// sentinel N included, add nothing and are never read.  Edge slots past
// indptr[b, N] are padding (sentinel id, zero factor); a row-parallel walk
// never visits them.
//
// Replaces: src/repro/kernels/s2v_csr.py::fused_s2v_layer_csr
// (_fused_csr_kernel).  The TPU kernel walks edge tiles in order, expands
// each tile's column and row ids into one-hot (TE, N) matrices and does the
// gather and the segment-sum as two MXU products into a (K, N) accumulator
// in VMEM, which caps N near 100k.  On Hopper the rows are independent: one
// warp owns one row and sums its edges in order, as s2v_gather.cu does for
// padded lists, so the sum is deterministic (no edge-parallel atomics) and
// nothing is held per graph, so N has no cap beyond device memory.  Row
// bounds come from indptr; row ids are not needed.
//
// What bounds it: bytes -- 8 bytes of (id, factor) and one x gather per edge
// for 2*K FLOPs.  x is read node-major (the wrapper passes a (B, N, K) or
// (B, N, KP) copy), one 128-byte line per edge at K = 32.  Two routes, both
// one chain per output in edge order with the same theta4 epilogue, so they
// give the same bits; the wrapper picks one per launch from the shapes
// (kernels/walk.py):
//
// - The row walk (csr_rows_kernel): one warp per row, x re-read from L2
//   once per edge.  Nothing is held per graph, so it is the route where x
//   is large next to the edges (BA(1M, d=10): windows would stream 1.0 TB
//   of x, 7813 blocks of 128 MB, against 160 MB of edges; a minibatch of
//   64 subgraphs sampled from it, N = 20,992: 28.2 GB of windows against
//   21 MB of edge slots).  A hub row is walked by one warp alone (BA(1M)
//   has a row of degree 8975), so that row's chain of 32-edge steps bounds
//   the kernel's time from below.  The aggregate takes the same walk with
//   the LAYER flag off: the same chain, acc stored with no theta4 product,
//   base or relu, so the aggregate's two routes give the same bits too.
// - The windowed walk (s2v_window.cuh, shared with s2v_gather.cu): 128
//   rows a block, 8 lanes a row, the graph's x streamed through 96 KB
//   shared-memory windows once per block, each row walked in 32-edge
//   chunks from its start rounded down to a 16-byte group (edges outside
//   the row masked, the arrays never copied), each row to its own end.
//   It pays where x is small next to the edges (the serving bucket: 134 MB
//   of windows against 160 MB of edge slots).  A hub row delays only its
//   own 8 lanes in each window.
#include "s2v_rows.cuh"
#include "s2v_window.cuh"

namespace {

using namespace s2v_rows;

// LAYER: relu(base + theta4 @ agg); otherwise agg itself (theta4 and base
// are not read and may be null).
template <bool BF16, bool LAYER>
__global__ void __launch_bounds__(THREADS)
csr_rows_kernel(const float* __restrict__ theta4,
                const float* __restrict__ xt,       // (B, N, K)
                const int* __restrict__ indptr,     // (B, N + 1)
                const int* __restrict__ indices,    // (B, E)
                const float* __restrict__ edge_w,   // (B, E)
                const float* __restrict__ base,     // (B, K, N)
                float* __restrict__ out,            // (B, K, N)
                int K, int N, int E) {
  __shared__ float t4T[32 * 32];
  __shared__ float stage[32][WARPS + 1];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * WARPS, i = i0 + warp;
  if (LAYER) load_theta4<BF16>(t4T, theta4, K);
  __syncthreads();

  float acc = 0.f;
  if (i < N) {                           // uniform across the warp
    const int* ip = indptr + (size_t)b * (N + 1);
    const int start = max(ip[i], 0), end = min(ip[i + 1], E);
    const size_t eb = (size_t)b * E;
    const float* xb = xt + (size_t)b * N * K;
    const bool k_lane = lane < K;
    int id = -1;
    float w = 0.f;
    if (start + lane < end) {
      id = indices[eb + start + lane];
      w = edge_w[eb + start + lane];
    }
    for (int e0 = start; e0 < end; e0 += 32) {
      const int cur_id = id;
      const float cur_w = w;
      const int en = e0 + 32 + lane;     // the next 32 edges, in flight
      id = -1;
      w = 0.f;
      if (en < end) {
        id = indices[eb + en];
        w = edge_w[eb + en];
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int j = __shfl_sync(FULL, cur_id, t);
        const float wj = __shfl_sync(FULL, cur_w, t);
        if ((unsigned)j < (unsigned)N && k_lane) {
          const float xv = xb[(size_t)j * K + lane];
          if (BF16)
            acc += round_cd<true>(round_cd<true>(xv) * round_cd<true>(wj));
          else
            acc = fmaf(xv, wj, acc);
        }
      }
    }
  }
  stage[lane][warp] = LAYER ? theta4_product<BF16>(t4T, acc, K, lane) : acc;
  __syncthreads();
  store_tile(stage, LAYER ? base : nullptr, out, b, K, N, i0);
}

// The row walk's launch, shared by the layer and the aggregate entries.
template <bool LAYER>
int launch_rows(const float* theta4, const float* xt, const int* indptr,
                const int* indices, const float* edge_w, const float* base,
                float* out, int B, int K, int N, int E, int bf16,
                void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 32 || N < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + WARPS - 1) / WARPS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    csr_rows_kernel<true, LAYER><<<grid, THREADS, 0, s>>>(
        theta4, xt, indptr, indices, edge_w, base, out, K, N, E);
  else
    csr_rows_kernel<false, LAYER><<<grid, THREADS, 0, s>>>(
        theta4, xt, indptr, indices, edge_w, base, out, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// The layer by the row walk.  theta4 (K, K); xt (B, N, K): the embeddings
// node-major, no sentinel column; indptr (B, N+1); indices and edge_w
// (B, E); base and out (B, K, N).  bf16 != 0 selects bf16 operand rounding.
// Returns cudaGetLastError().
extern "C" int s2v_csr_layer(const float* theta4, const float* xt,
                             const int* indptr, const int* indices,
                             const float* edge_w, const float* base,
                             float* out, int B, int K, int N, int E, int bf16,
                             void* stream) {
  return launch_rows<true>(theta4, xt, indptr, indices, edge_w, base, out, B,
                           K, N, E, bf16, stream);
}

// The layer by the windowed walk.  As s2v_csr_layer, but xt (B, N, KP) with
// each row padded with zeros to KP = K rounded up to a multiple of 4, and
// xt, indices and edge_w 16-byte aligned.  Returns the first CUDA error, if
// any.
extern "C" int s2v_csr_layer_windowed(const float* theta4, const float* xt,
                                      const int* indptr, const int* indices,
                                      const float* edge_w, const float* base,
                                      float* out, int B, int K, int KP, int N,
                                      int E, int bf16, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 32 || N < 1 || E < 1 ||
      KP % 4 != 0 || KP < K || KP > 32 ||
      (reinterpret_cast<uintptr_t>(xt) | reinterpret_cast<uintptr_t>(indices) |
       reinterpret_cast<uintptr_t>(edge_w)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const s2v_window::Args p{xt, indices, edge_w, indptr, theta4, base, out,
                           K, KP, N, N, E};
  return (int)s2v_window::launch_layer<s2v_window::CSR>(
      p, B, bf16, static_cast<cudaStream_t>(stream));
}

// The aggregate by the windowed walk: out (B, K, N) = agg, the f32 sums,
// with xt, indptr, indices and edge_w as for s2v_csr_layer_windowed.
// bf16 != 0 sums the bf16 products, as the layer does.  Returns the first
// CUDA error, if any.
extern "C" int s2v_csr_aggregate(const float* xt, const int* indptr,
                                 const int* indices, const float* edge_w,
                                 float* out, int B, int K, int KP, int N,
                                 int E, int bf16, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 32 || N < 1 || E < 1 ||
      KP % 4 != 0 || KP < K || KP > 32 ||
      (reinterpret_cast<uintptr_t>(xt) | reinterpret_cast<uintptr_t>(indices) |
       reinterpret_cast<uintptr_t>(edge_w)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const s2v_window::Args p{xt, indices, edge_w, indptr, nullptr, nullptr,
                           out, K, KP, N, N, E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16
      ? s2v_window::launch<s2v_window::CSR, true, false>(p, B, s)
      : s2v_window::launch<s2v_window::CSR, false, false>(p, B, s));
}

// The aggregate by the row walk: out (B, K, N) = agg, the f32 sums, with xt,
// indptr, indices and edge_w as for s2v_csr_layer.  bf16 != 0 sums the bf16
// products, as the layer does.  Returns cudaGetLastError().
extern "C" int s2v_csr_aggregate_rows(const float* xt, const int* indptr,
                                      const int* indices, const float* edge_w,
                                      float* out, int B, int K, int N, int E,
                                      int bf16, void* stream) {
  return launch_rows<false>(nullptr, xt, indptr, indices, edge_w, nullptr,
                            out, B, K, N, E, bf16, stream);
}
