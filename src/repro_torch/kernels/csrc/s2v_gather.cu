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
// Hopper gathers.  x is read node-major (the wrapper passes a (B, ncols, K)
// copy), so one neighbour is one 128-byte line at K = 32.
//
// Kernel 3 (sparse_rows_kernel, shared with s2v_csr.cu through
// s2v_rows.cuh): one warp owns one node and lane k owns row k.  The warp
// loads 32 slot ids and factors at once (one coalesced word each per
// lane), the next 32 are already in flight while the current ones are
// broadcast with __shfl_sync, and each neighbour is one FMA per lane.  The
// (K, Nl) aggregate never reaches device memory.
//
// What bounds it: the work is a gather, 2*K FLOPs per slot against 8 bytes
// of (id, factor) per slot, so it is bound by bytes.  Kernel 3 re-reads x
// once per edge, mostly from L2 (a 4096-node graph's x is 512 KB): about
// 2.5 GB of L2 traffic and 50M shuffles per serving bucket.
//
// Kernel 4 (windowed_aggregate_kernel) reads x once per block instead: a
// block owns AGG_NODES nodes of one graph and streams that graph's x
// through shared memory in ascending windows of ids (96 KB each,
// double-buffered, 16-byte cp.async copies), a block-wide barrier between
// windows.  Eight lanes own one node, each lane four consecutive k (one
// float4 from shared memory per slot), so one width-8 shuffle of a slot's
// id serves four nodes at once.  A node's slots are walked in chunks of
// 32 aligned to its list (one 16-byte load of ids and one of factors per
// lane, the next chunk in flight); its lanes advance a cursor while the
// slot's id is below the window's end, reading x from the window, or from
// global memory for an id below it (only lists that are not ascending have
// those), and a window that ends inside a chunk leaves an offset into it.
// Slots that add exactly zero are passed over in any window: ids outside
// [0, ncols), and the sentinel N when x's sentinel column is zero (checked
// per block) and the factor finite; otherwise the sentinel is summed like
// any id.  So every other slot is summed once, in slot order, and each
// output is one fmaf chain over its slots in ascending slot order, less
// additions of exact zeros: the values equal kernel 3's walk and the dense
// aggregate's (kernel 2) for any list.
#include "s2v_rows.cuh"

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

constexpr int AGG_NODES = 128;                 // output nodes per block
constexpr int AGG_THREADS = 8 * AGG_NODES;     // 8 lanes per node
constexpr int WINDOW_FLOATS = 24576;           // 96 KB of x per window
constexpr int AGG_SMEM = 2 * WINDOW_FLOATS * (int)sizeof(float);

__device__ __forceinline__ int comp(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float compf(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Kernel 4: out[b, k, i] = sum_d xt[b, nbr[b,i,d], k] * edge[b,i,d], one
// fmaf chain per (i, k) in slot order.  xt (B, ncols, KP) with KP = K
// rounded up to 4 (zero rows k >= K), so one node's row is whole float4s;
// D a multiple of 4 and nbr, edge 16-byte aligned, so four slots are one
// 16-byte load.
__global__ void __launch_bounds__(AGG_THREADS, 1)
windowed_aggregate_kernel(const float* __restrict__ xt,
                          const int* __restrict__ nbr,
                          const float* __restrict__ edge,
                          float* __restrict__ out, int K, int KP, int ncols,
                          int Nl, int D) {
  extern __shared__ __align__(16) float win[];   // two windows of x
  __shared__ float stage[32][AGG_NODES + 1];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32, sub = lane % 8;
  const int node = threadIdx.x / 8, i = blockIdx.x * AGG_NODES + node;
  const int k0 = 4 * sub;
  const bool k_on = k0 < KP;
  const int nd = i < Nl ? D : 0;                 // this node's slots
  const size_t row = ((size_t)b * Nl + (i < Nl ? i : 0)) * D;
  const float* xb = xt + (size_t)b * ncols * KP;
  const int rows = WINDOW_FLOATS / KP;           // ids per window
  const int nwin = (ncols + rows - 1) / rows;
  // The sentinel column N = ncols - 1 is zero by the wrapper's contract;
  // where it is, a sentinel slot with a finite factor adds exactly zero,
  // so it is passed over in any window instead of waiting for the last.
  const int sentinel = __syncthreads_and(
      threadIdx.x >= KP || xb[(size_t)(ncols - 1) * KP + threadIdx.x] == 0.f)
      ? ncols - 1 : -1;

  auto fetch = [&](int w) {                      // window w into buffer w % 2
    const int r0 = w * rows;
    const int n4 = (min(r0 + rows, ncols) - r0) * KP / 4;
    float* dst = win + (w & 1) * WINDOW_FLOATS;
    const float* src = xb + (size_t)r0 * KP;
    for (int c = threadIdx.x; c < n4; c += AGG_THREADS)
      cp_async16(dst + 4 * c, src + 4 * c);
  };
  // The node's slots are walked in chunks of 32 aligned to its list: lane
  // sub holds slots c0 + 4 sub + c (c = 0..3, one 16-byte load of ids and
  // one of factors, D being a multiple of 4), of which the first `off` are
  // summed.  The next chunk is in flight while this one is summed.
  auto load_chunk = [&](int c, int4& id, float4& w) {
    const int s = c + 4 * sub;
    id = make_int4(-1, -1, -1, -1);
    w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < nd) {
      id = *reinterpret_cast<const int4*>(nbr + row + s);
      w = *reinterpret_cast<const float4*>(edge + row + s);
    }
  };
  int c0 = 0, off = 0;
  int4 id, nid;
  float4 wv, nwv;
  load_chunk(0, id, wv);
  load_chunk(32, nid, nwv);
  fetch(0);
  cp_async_commit();
  if (nwin > 1) fetch(1);
  cp_async_commit();
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int w = 0; w < nwin; ++w) {
    cp_async_wait1();                            // window w has landed
    __syncthreads();
    const int w0 = w * rows, wend = min(w0 + rows, ncols);
    const float* buf = win + (w & 1) * WINDOW_FLOATS;
    for (;;) {
      // a slot is ready when it is summed already (below off) or this
      // window finishes it (its id is below the window's end, or outside
      // [0, ncols), which adds nothing); slots [off, end) are summed now
      int bad = 4;                               // this lane's first unready
      int work = -1;                             // its last slot with work
#pragma unroll
      for (int c = 3; c >= 0; --c) {
        const int t = 4 * sub + c, j = comp(id, c);
        const bool none = (unsigned)j >= (unsigned)ncols ||
                          (j == sentinel && isfinite(compf(wv, c)));
        const bool r = t < off || (c0 + t < nd && (none || j < wend));
        if (!r) bad = c;
        if (t >= off && c0 + t < nd && !none && work < 0) work = t;
      }
      const unsigned lanes = (__ballot_sync(FULL, bad < 4) >> (lane & 24)) &
                             0xffu;
      const int first = __ffs(lanes) - 1;       // -1: all 32 ready
      const int bad_there = __shfl_sync(FULL, bad, first & 7, 8);
      const int end = first < 0 ? 32 : 4 * first + bad_there;
      // the t range with work: from the lowest offset to the last slot
      // before end that is not passed over
      const int t_lo = __reduce_min_sync(FULL, off);
      const int t_hi = __reduce_max_sync(FULL, work < end ? work + 1 : end);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (8 * q + 8 <= t_lo || 8 * q >= t_hi) continue;   // warp-uniform
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int t = 8 * q + u;
          const int j = __shfl_sync(FULL, comp(id, t % 4), t / 4, 8);
          const float wj = __shfl_sync(FULL, compf(wv, t % 4), t / 4, 8);
          if (t >= off && t < end && (unsigned)j < (unsigned)ncols &&
              k_on && !(j == sentinel && isfinite(wj))) {
            const float4 xv =
                j >= w0 ? *reinterpret_cast<const float4*>(
                              buf + (size_t)(j - w0) * KP + k0)
                        : __ldg(reinterpret_cast<const float4*>(
                              xb + (size_t)j * KP + k0));
            a0 = fmaf(xv.x, wj, a0);
            a1 = fmaf(xv.y, wj, a1);
            a2 = fmaf(xv.z, wj, a2);
            a3 = fmaf(xv.w, wj, a3);
          }
        }
      }
      const bool more = end == 32 && c0 + 32 < nd;
      if (end == 32) {                           // the chunk is summed
        c0 += 32;
        off = 0;
        id = nid;
        wv = nwv;
        load_chunk(c0 + 32, nid, nwv);
      } else {
        off = end;                               // waits for a later window
      }
      if (!__any_sync(FULL, more)) break;
    }
    __syncthreads();                             // buffer w % 2 is free
    if (w + 2 < nwin) fetch(w + 2);
    cp_async_commit();
  }

  if (k_on) {
    const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int c = 0; c < 4; ++c) stage[k0 + c][node] = acc[c];
  }
  __syncthreads();
  const int i0 = blockIdx.x * AGG_NODES;
  for (int t = threadIdx.x; t < K * AGG_NODES; t += AGG_THREADS) {
    const int k = t / AGG_NODES, n = t % AGG_NODES;
    if (i0 + n < Nl) out[((size_t)b * K + k) * Nl + i0 + n] = stage[k][n];
  }
}

bool bad_sizes(int B, int K, int ncols, int Nl, int D) {
  return B < 1 || B > 65535 || K < 1 || K > 32 || ncols < 1 || Nl < 1 ||
         D < 1;
}

}  // namespace

// Kernel 4.  xt (B, N+1, KP): the embeddings node-major with the zero
// sentinel column, each row padded with zeros from K to KP = K rounded up to
// a multiple of 4; nbr and edge (B, Nl, D), D a multiple of 4: the neighbour
// lists of Nl nodes (Nl = N on one device, a row block of a graph split over
// a mesh's graph axis otherwise), with global ids; out (B, K, Nl).  f32.
// xt, nbr and edge 16-byte aligned.  Returns the first CUDA error, if any.
extern "C" int s2v_sparse_aggregate(const float* xt, const int* nbr,
                                    const float* edge, float* out, int B,
                                    int K, int KP, int N, int Nl, int D,
                                    void* stream) {
  if (bad_sizes(B, K, N + 1, Nl, D) || KP % 4 != 0 || KP < K || KP > 32 ||
      D % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(xt) | reinterpret_cast<uintptr_t>(nbr) |
       reinterpret_cast<uintptr_t>(edge)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // the whole carveout as shared memory
  cudaError_t err = cudaFuncSetAttribute(
      windowed_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AGG_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(windowed_aggregate_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nl + AGG_NODES - 1) / AGG_NODES, B);
  windowed_aggregate_kernel<<<grid, AGG_THREADS, AGG_SMEM,
                              static_cast<cudaStream_t>(stream)>>>(
      xt, nbr, edge, out, K, KP, N + 1, Nl, D);
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
    sparse_rows_kernel<true><<<grid, THREADS, 0, s>>>(
        theta4, xt, nbr, edge, base, out, K, N, Nl, D);
  else
    sparse_rows_kernel<false><<<grid, THREADS, 0, s>>>(
        theta4, xt, nbr, edge, base, out, K, N, Nl, D);
  return (int)cudaGetLastError();
}
