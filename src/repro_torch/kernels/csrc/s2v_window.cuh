// The windowed walk of the gather kernels, shared by the padded-sparse
// aggregate (B4) and fused layer (B3) in s2v_gather.cu and the CSR fused
// layer (B5) and its aggregate in s2v_csr.cu:
//
//   agg[b,k,i] = sum over node i's slots of p(x[b, ids[slot], k], w[slot])
//
// in slot order, one chain per (i, k): p is fmaf(cd(x), cd(w), acc), or
// acc + cd(cd(x) * cd(w)) for the CSR layer at bf16 (its composition
// rounds each product), with cd() the compute-dtype rounding.  The layer
// epilogue then writes relu(base + sum_j cd(theta4[k, j]) * cd(agg[j])),
// one fmaf chain over ascending j, the aggregate epilogue agg itself.
//
// A block owns NODES nodes of one graph and streams that graph's x
// (node-major, (ncols, KP) with KP = K rounded up to 4 and zero rows
// k >= K) through shared memory in ascending windows of ids (96 KB each,
// double-buffered, 16-byte cp.async copies), a block-wide barrier between
// windows.  Eight lanes own one node, each lane four consecutive k (one
// float4 from shared memory per slot), so one width-8 shuffle of a slot's
// id serves four nodes at once.  A node's slots are walked in chunks of 32
// from its first slot rounded down to a 16-byte group (one 16-byte load of
// ids and one of factors per lane, the next chunk in flight; slots of a
// group outside the node's are masked).  Its lanes advance a cursor while
// the slot's id is below the window's end, reading x from the window, or
// from global memory for an id below it (only lists that are not
// ascending have those), and a window that ends inside a chunk leaves an
// offset into it.  Slots whose id lies outside [0, ncols) add nothing and
// are passed over in any window; the padded lists' aggregate also passes
// over the sentinel N where x's sentinel column is zero (checked per block)
// and the factor finite, since such a slot adds exactly zero.  No slot is
// passed over because of its factor alone.  So every other slot is summed
// once, in slot order, and each output is the same fmaf chain as the row
// walk's (s2v_rows.cuh) and the dense layer's, less additions of exact
// zeros.
//
// What bounds it: x comes from L2 once per block (blocks x ncols x KP x 4
// bytes), the lists from HBM once (8 bytes a slot), and every slot of a
// node costs its lanes a shuffle of its id and factor.  The walk pays
// where x is small next to the lists (the wrappers choose it by comparing
// the two byte counts, ``kernels/walk.py``).
#pragma once

#include "s2v_rows.cuh"

namespace s2v_window {

using s2v_rows::FULL;
using s2v_rows::round_cd;

constexpr int NODES = 128;                     // output nodes per block
constexpr int THREADS = 8 * NODES;             // 8 lanes per node
constexpr int WINDOW_FLOATS = 24576;           // 96 KB of x per window
constexpr int SMEM = 2 * WINDOW_FLOATS * (int)sizeof(float);

// How a node's slots lie in the list arrays.
enum Lists {
  PADDED4,   // (B, Nl, D), D % 4 == 0: every list starts on a 16-byte group
  PADDED,    // (B, Nl, D), any D
  CSR,       // (B, E): node i's slots [indptr[b,i], indptr[b,i+1]) of row b
};

struct Args {
  const float* xt;       // (B, ncols, KP), rows k >= K zero
  const int* ids;        // the slots' ids and factors, 16-byte aligned
  const float* w;
  const int* indptr;     // CSR: (B, Nl + 1)
  const float* theta4;   // the layer: (K, K)
  const float* base;     // the layer: (B, K, Nl)
  float* out;            // (B, K, Nl)
  int K, KP, ncols, Nl;
  int D;                 // padded: the list width; CSR: the slots a row, E
};

namespace {

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

// acc plus the product of x and w (w already rounded to the compute
// dtype): one fmaf, or at ROUNDED the bf16 product added in f32.
template <bool BF16, bool ROUNDED>
__device__ __forceinline__ float add_product(float x, float w, float acc) {
  if (ROUNDED) return acc + round_cd<true>(round_cd<true>(x) * w);
  return fmaf(round_cd<BF16>(x), w, acc);
}

template <int LISTS, bool BF16, bool LAYER>
__global__ void __launch_bounds__(THREADS, 1)
windowed_kernel(const Args p) {
  constexpr bool ROUNDED = BF16 && LISTS == CSR;
  extern __shared__ __align__(16) float win[];   // two windows of x
  __shared__ float stage[32][NODES + 1];
  __shared__ float t4T[LAYER ? 32 * 32 : 1];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32, sub = lane % 8;
  const int node = threadIdx.x / 8, i = blockIdx.x * NODES + node;
  const int k0 = 4 * sub;
  const bool k_on = k0 < p.KP;
  const int ncols = p.ncols;
  // The node's slots are elements [s, e) of the list arrays, walked from
  // a = s rounded down to a 16-byte group: walk slot q is element a + q,
  // and the node's own are q in [lo, hi).
  size_t s = 0, e = 0;
  if (i < p.Nl) {
    if (LISTS == CSR) {
      const int* ip = p.indptr + (size_t)b * (p.Nl + 1);
      const int r0 = min(max(ip[i], 0), p.D);
      s = (size_t)b * p.D + r0;
      e = (size_t)b * p.D + max(min(ip[i + 1], p.D), r0);
    } else {
      s = ((size_t)b * p.Nl + i) * p.D;
      e = s + p.D;
    }
  }
  const size_t a = LISTS == PADDED4 ? s : s & ~(size_t)3;
  const int lo = LISTS == PADDED4 ? 0 : (int)(s - a);
  const int hi = (int)(e - a);
  const size_t total =
      (size_t)gridDim.y * (LISTS == CSR ? 1 : p.Nl) * p.D;
  const float* xb = p.xt + (size_t)b * ncols * p.KP;
  const int rows = WINDOW_FLOATS / p.KP;         // ids per window
  const int nwin = (ncols + rows - 1) / rows;
  // The padded lists' aggregate has a sentinel column N = ncols - 1, zero
  // by its wrapper's contract; where it is, a sentinel slot with a finite
  // factor adds exactly zero, so it is passed over in any window instead
  // of waiting for the last.  The layers' x and the CSR aggregate's have
  // no sentinel column: their sentinel N lies outside [0, ncols) already.
  constexpr bool SENTINEL = !LAYER && LISTS != CSR;
  int sentinel = -1;
  if (SENTINEL)
    sentinel = __syncthreads_and(
        threadIdx.x >= p.KP ||
        xb[(size_t)(ncols - 1) * p.KP + threadIdx.x] == 0.f) ? ncols - 1 : -1;
  if (LAYER) s2v_rows::load_theta4<BF16>(t4T, p.theta4, p.K);

  auto fetch = [&](int w) {                      // window w into buffer w % 2
    const int r0 = w * rows;
    const int n4 = (min(r0 + rows, ncols) - r0) * p.KP / 4;
    float* dst = win + (w & 1) * WINDOW_FLOATS;
    const float* src = xb + (size_t)r0 * p.KP;
    for (int c = threadIdx.x; c < n4; c += THREADS)
      cp_async16(dst + 4 * c, src + 4 * c);
  };
  // Lane sub holds walk slots c0 + 4 sub + c (c = 0..3), one 16-byte
  // group of ids and one of factors, of which the first `off` of the
  // chunk are summed.  The next chunk is in flight while this one is
  // summed.
  auto load_chunk = [&](int c, int4& id, float4& wv) {
    const int q = c + 4 * sub;
    id = make_int4(-1, -1, -1, -1);
    wv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q >= hi) return;
    const size_t g = a + q;
    if (LISTS == PADDED4 || g + 4 <= total) {
      id = *reinterpret_cast<const int4*>(p.ids + g);
      wv = *reinterpret_cast<const float4*>(p.w + g);
    } else {                                     // the arrays' last group
      if (g < total) { id.x = p.ids[g]; wv.x = p.w[g]; }
      if (g + 1 < total) { id.y = p.ids[g + 1]; wv.y = p.w[g + 1]; }
      if (g + 2 < total) { id.z = p.ids[g + 2]; wv.z = p.w[g + 2]; }
    }
    if (LISTS != PADDED4) {                      // slots not the node's
      if (q < lo || q >= hi) id.x = -1;
      if (q + 1 < lo || q + 1 >= hi) id.y = -1;
      if (q + 2 < lo || q + 2 >= hi) id.z = -1;
      if (q + 3 >= hi) id.w = -1;
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
      // window finishes it (its id is below the window's end, or it is
      // passed over); slots [off, end) are summed now, and a walk slot at
      // or past hi stops the node
      int bad = 4;                               // this lane's first unready
      int work = -1;                             // its last slot with work
#pragma unroll
      for (int c = 3; c >= 0; --c) {
        const int t = 4 * sub + c, j = comp(id, c);
        const bool none =
            (unsigned)j >= (unsigned)ncols ||
            (SENTINEL && j == sentinel && isfinite(compf(wv, c)));
        const bool r = t < off || (c0 + t < hi && (none || j < wend));
        if (!r) bad = c;
        if (t >= off && c0 + t < hi && !none && work < 0) work = t;
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
              k_on && !(SENTINEL && j == sentinel && isfinite(wj))) {
            const float4 xv =
                j >= w0 ? *reinterpret_cast<const float4*>(
                              buf + (size_t)(j - w0) * p.KP + k0)
                        : __ldg(reinterpret_cast<const float4*>(
                              xb + (size_t)j * p.KP + k0));
            const float wr = round_cd<BF16>(wj);
            a0 = add_product<BF16, ROUNDED>(xv.x, wr, a0);
            a1 = add_product<BF16, ROUNDED>(xv.y, wr, a1);
            a2 = add_product<BF16, ROUNDED>(xv.z, wr, a2);
            a3 = add_product<BF16, ROUNDED>(xv.w, wr, a3);
          }
        }
      }
      const bool more = end == 32 && c0 + 32 < hi;
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
    for (int c = 0; c < 4; ++c)
      stage[k0 + c][node] = LAYER ? round_cd<BF16>(acc[c]) : acc[c];
  }
  __syncthreads();
  // each k row of the block's nodes goes out as consecutive floats; the
  // layer's theta4 product is s2v_rows::theta4_product's chain, term for
  // term, and its store s2v_rows::store_tile's
  const int i0 = blockIdx.x * NODES;
  for (int t = threadIdx.x; t < p.K * NODES; t += THREADS) {
    const int k = t / NODES, n = t % NODES;
    if (i0 + n >= p.Nl) continue;
    const size_t o = ((size_t)b * p.K + k) * p.Nl + i0 + n;
    if (LAYER) {
      float e3 = 0.f;
      for (int j = 0; j < p.K; ++j)
        e3 = fmaf(t4T[j * 32 + k], stage[j][n], e3);
      p.out[o] = fmaxf(p.base[o] + e3, 0.f);
    } else {
      p.out[o] = stage[k][n];
    }
  }
}

// Launches the walk over B graphs on `stream`, with the whole carveout as
// shared memory.  Returns the first CUDA error, if any.
template <int LISTS, bool BF16, bool LAYER>
cudaError_t launch(const Args& p, int B, cudaStream_t stream) {
  auto kernel = windowed_kernel<LISTS, BF16, LAYER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Nl + NODES - 1) / NODES, B);
  kernel<<<grid, THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The layer (B3, B5) at f32 or bf16 (bf16 != 0).
template <int LISTS>
cudaError_t launch_layer(const Args& p, int B, int bf16,
                         cudaStream_t stream) {
  return bf16 ? launch<LISTS, true, true>(p, B, stream)
              : launch<LISTS, false, true>(p, B, stream);
}

}  // namespace
}  // namespace s2v_window
