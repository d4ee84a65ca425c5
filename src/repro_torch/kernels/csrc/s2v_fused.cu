// Dense structure2vec kernels for Hopper (sm_90a):
//
//   acc[b,k,n] = sum_l cd(embed[b,k,l]) * cd(adj[b,l,n])        (f32 accumulation)
//   s2v_fused_layer:  out[b,k,n] = relu(base[b,k,n] + sum_j cd(theta4[k,j]) * cd(acc[b,j,n]))
//   s2v_mp_aggregate: out[b,k,n] = acc[b,k,n]
//
// cd() is the compute-dtype rounding: the identity for f32, round-to-nearest-
// even to bf16 for bf16, applied once to each staged tile in shared memory,
// so no bf16 copy of adj is ever materialised in device memory.  In the
// fused layer the aggregate is rounded once, before the theta4 product;
// base, the sum and the ReLU stay f32.  The aggregate alone is stored in f32
// unrounded: it is the partial sum of one row block that the mesh path
// all-reduces across ranks before its epilogue.
//
// Replaces: src/repro/kernels/s2v_fused.py::fused_s2v_layer, whose Pallas
// body _fused_dense_kernel runs the l axis as a sequential grid dimension
// and carries the (K, TN) sum across grid steps in VMEM scratch, and
// s2v_fused.py::mp_aggregate (_agg_kernel), the same loop without the
// epilogue.  Blocks of a CUDA grid run in parallel and in no order, so here
// one block owns one (b, n-tile) and loops over the l tiles itself, keeping
// the K x TN accumulator in registers; in the fused layer the (B, K, N)
// aggregate never reaches device memory, which is the point of the TPU
// kernel.  The TPU's mp_aggregate pads embed and adj to tile multiples in
// device memory first; here the ragged edges (l >= Nl, n >= N) are masked
// inside the copies, so nothing is padded.
//
// What bounds it: at f32 both kernels read B*Nl*N*4 bytes of adj and do
// 2*B*K*Nl*N FLOPs, 16 FLOP/byte at K=32 -- close to the H100's balance
// point for f32 on CUDA cores (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so
// both bounds matter; the aggregate also writes B*K*N*4 bytes.  The design
// reads adj exactly once, with 16-byte coalesced copies; the copies of the
// next (adj, embed) tile pair are issued with cp.async into a second
// shared-memory buffer before the current pair is multiplied, so they are in
// flight during the FMAs without holding registers; each thread owns a
// (K/4) x 2 register tile, so every shared-memory load feeds several FMAs;
// and the tiles are narrow (64 columns, 128 threads) so that even one graph
// of 20480 nodes makes 320 blocks for the 132 SMs.  TMA staging and tensor
// cores are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;                  // output columns per block
constexpr int TL = 32;                  // contraction rows staged per step
constexpr int THREADS = 128;
constexpr int COL_PAIRS = TN / 2;       // each thread owns 2 adjacent columns
constexpr int KGROUPS = THREADS / COL_PAIRS;   // 4 groups of K/4 rows

template <bool BF16>
__device__ __forceinline__ float round_cd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Asynchronous global -> shared copies; src_bytes = 0 writes zeros, which
// is how the ragged edges (l >= Nl, n >= N) are padded.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N_PENDING));
}

// FUSED: the layer (theta4, base, ReLU epilogue); otherwise the aggregate
// alone (theta4 and base unused).
template <int KP, bool BF16, bool FUSED>
__global__ void __launch_bounds__(THREADS)
fused_dense_kernel(const float* __restrict__ theta4,
                   const float* __restrict__ embed,
                   const float* __restrict__ adj,
                   const float* __restrict__ base,
                   float* __restrict__ out,
                   int K, int Nl, int N, bool vec4) {
  constexpr int KPT = KP / KGROUPS;     // rows per thread: 2, 4 or 8
  static_assert(KP <= TL, "the aggregate reuses an adj tile buffer");
  __shared__ float t4_s[FUSED ? KP : 1][FUSED ? KP + 1 : 1];
  __shared__ __align__(16) float e_s[2][KP][TL];   // embed tiles, l contiguous
  __shared__ __align__(16) float a_s[2][TL * TN];  // adj tiles; then the aggregate

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int cp = tid % COL_PAIRS;
  const int k0 = (tid / COL_PAIRS) * KPT;   // one k-group per warp
  const float* adj_b = adj + (size_t)b * Nl * N;
  const float* emb_b = embed + (size_t)b * K * Nl;

  if constexpr (FUSED) {
    for (int i = tid; i < KP * KP; i += THREADS) {
      const int r = i / KP, q = i % KP;
      t4_s[r][q] = (r < K && q < K) ? round_cd<BF16>(theta4[r * K + q]) : 0.f;
    }
  }

  // Issue the copies of the tile pair starting at row l0 into buffer buf.
  auto issue = [&](int l0, int buf) {
    if (vec4) {   // a warp copies two 256-byte adj row segments
      for (int i = tid; i < TL * TN / 4; i += THREADS) {
        const int r = i / (TN / 4), q = (i % (TN / 4)) * 4;
        const int l = l0 + r, n = n0 + q;
        const bool ok = l < Nl && n < N;   // N % 4 == 0: all four or none
        cp_async16(&a_s[buf][r * TN + q],
                   ok ? adj_b + (size_t)l * N + n : adj_b, ok);
      }
    } else {
      for (int i = tid; i < TL * TN; i += THREADS) {
        const int l = l0 + i / TN, n = n0 + i % TN;
        const bool ok = l < Nl && n < N;
        cp_async4(&a_s[buf][i], ok ? adj_b + (size_t)l * N + n : adj_b, ok);
      }
    }
    for (int i = tid; i < KP * TL; i += THREADS) {   // coalesced along l
      const int k = i / TL, l = l0 + i % TL;
      const bool ok = k < K && l < Nl;
      cp_async4(&e_s[buf][k][i % TL], ok ? emb_b + (size_t)k * Nl + l : emb_b,
                ok);
    }
    cp_async_commit();
  };
  // bf16: round, in place and once, the elements this thread copied (its
  // own copies are complete and visible to it after the wait).
  auto round_own = [&](int buf) {
    const int a_step = vec4 ? 4 : 1;
    for (int i = tid * a_step; i < TL * TN; i += THREADS * a_step)
      for (int v = 0; v < a_step; ++v)
        a_s[buf][i + v] = round_cd<true>(a_s[buf][i + v]);
    for (int i = tid; i < KP * TL; i += THREADS)
      e_s[buf][i / TL][i % TL] = round_cd<true>(e_s[buf][i / TL][i % TL]);
  };

  float acc[KPT][2];
#pragma unroll
  for (int kk = 0; kk < KPT; ++kk) acc[kk][0] = acc[kk][1] = 0.f;

  issue(0, 0);
  int buf = 0;
  for (int l0 = 0; l0 < Nl; l0 += TL, buf ^= 1) {
    if (l0 + TL < Nl) {
      issue(l0 + TL, buf ^ 1);          // in flight during the FMAs below
      cp_async_wait<1>();               // this thread's copies of tile l0
    } else {
      cp_async_wait<0>();
    }
    if (BF16) round_own(buf);
    __syncthreads();                    // everyone's copies of tile l0

    const float* a_t = a_s[buf];
#pragma unroll 2
    for (int r = 0; r < TL; r += 4) {
      float2 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = *reinterpret_cast<const float2*>(&a_t[(r + u) * TN + 2 * cp]);
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) {
        // every lane of a warp reads the same address: a broadcast
        const float4 e = *reinterpret_cast<const float4*>(&e_s[buf][k0 + kk][r]);
        acc[kk][0] = fmaf(e.x, a[0].x, acc[kk][0]);
        acc[kk][1] = fmaf(e.x, a[0].y, acc[kk][1]);
        acc[kk][0] = fmaf(e.y, a[1].x, acc[kk][0]);
        acc[kk][1] = fmaf(e.y, a[1].y, acc[kk][1]);
        acc[kk][0] = fmaf(e.z, a[2].x, acc[kk][0]);
        acc[kk][1] = fmaf(e.z, a[2].y, acc[kk][1]);
        acc[kk][0] = fmaf(e.w, a[3].x, acc[kk][0]);
        acc[kk][1] = fmaf(e.w, a[3].y, acc[kk][1]);
      }
    }
    __syncthreads();                    // buffer buf is refilled next-but-one
  }

  if constexpr (!FUSED) {   // the f32 aggregate, unrounded: 256 bytes a warp
    const int n = n0 + 2 * cp;
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      const int k = k0 + kk;
      if (k >= K) break;
      const size_t row = ((size_t)b * K + k) * N;
      if (n < N) out[row + n] = acc[kk][0];
      if (n + 1 < N) out[row + n + 1] = acc[kk][1];
    }
  } else {
    // Epilogue: the aggregate, rounded once, goes through shared memory so
    // that each thread sees all K rows of its columns for the theta4 product.
    float* agg_s = a_s[0];                // [KP][TN]
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      agg_s[(k0 + kk) * TN + 2 * cp] = round_cd<BF16>(acc[kk][0]);
      agg_s[(k0 + kk) * TN + 2 * cp + 1] = round_cd<BF16>(acc[kk][1]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      const int k = k0 + kk;
      if (k >= K) break;
      float e3x = 0.f, e3y = 0.f;
#pragma unroll 8
      for (int j = 0; j < KP; ++j) {
        const float t = t4_s[k][j];
        const float2 g = *reinterpret_cast<const float2*>(&agg_s[j * TN + 2 * cp]);
        e3x = fmaf(t, g.x, e3x);
        e3y = fmaf(t, g.y, e3y);
      }
      const size_t row = ((size_t)b * K + k) * N;
      const int n = n0 + 2 * cp;
      if (n < N) out[row + n] = fmaxf(base[row + n] + e3x, 0.f);
      if (n + 1 < N) out[row + n + 1] = fmaxf(base[row + n + 1] + e3y, 0.f);
    }
  }
}

template <int KP, bool FUSED>
void launch(dim3 grid, cudaStream_t s, const float* theta4,
            const float* embed, const float* adj, const float* base,
            float* out, int K, int Nl, int N, bool bf16, bool vec4) {
  if (bf16)
    fused_dense_kernel<KP, true, FUSED><<<grid, THREADS, 0, s>>>(
        theta4, embed, adj, base, out, K, Nl, N, vec4);
  else
    fused_dense_kernel<KP, false, FUSED><<<grid, THREADS, 0, s>>>(
        theta4, embed, adj, base, out, K, Nl, N, vec4);
}

template <bool FUSED>
int launch_k(const float* theta4, const float* embed, const float* adj,
             const float* base, float* out, int B, int K, int Nl, int N,
             int bf16, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 32 || Nl < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TN - 1) / TN, B);
  const bool vec4 = (N % 4 == 0) && ((uintptr_t)adj % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 8)
    launch<8, FUSED>(grid, s, theta4, embed, adj, base, out, K, Nl, N,
                     bf16 != 0, vec4);
  else if (K <= 16)
    launch<16, FUSED>(grid, s, theta4, embed, adj, base, out, K, Nl, N,
                      bf16 != 0, vec4);
  else
    launch<32, FUSED>(grid, s, theta4, embed, adj, base, out, K, Nl, N,
                      bf16 != 0, vec4);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 1.  Launches the fused layer on `stream`.  All tensors are f32 and
// contiguous: theta4 (K,K), embed (B,K,Nl), adj (B,Nl,N), base and out
// (B,K,N).  bf16 != 0 selects bf16 operand rounding.  Returns
// cudaGetLastError().
extern "C" int s2v_fused_layer(const float* theta4, const float* embed,
                               const float* adj, const float* base, float* out,
                               int B, int K, int Nl, int N, int bf16,
                               void* stream) {
  return launch_k<true>(theta4, embed, adj, base, out, B, K, Nl, N, bf16,
                        stream);
}

// Kernel 2.  Launches the aggregate on `stream`: embed (B,K,Nl), adj
// (B,Nl,N), out (B,K,N), all f32 and contiguous.  bf16 != 0 rounds the
// operands to bf16; the sum and the output stay f32.  Returns
// cudaGetLastError().
extern "C" int s2v_mp_aggregate(const float* embed, const float* adj,
                                float* out, int B, int K, int Nl, int N,
                                int bf16, void* stream) {
  return launch_k<false>(nullptr, embed, adj, nullptr, out, B, K, Nl, N, bf16,
                         stream);
}
