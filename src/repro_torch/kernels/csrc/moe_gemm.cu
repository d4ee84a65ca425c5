// Grouped expert GLU FFN for Hopper (sm_90a), two kernels over per-expert
// capacity buffers, all f32:
//
//   moe_glu:  h[e,c,n] = silu(sum_k x[e,c,k] wg[e,k,n]) * (sum_k x[e,c,k] wu[e,k,n])
//   moe_proj: y[e,c,n] = sum_k h[e,c,k] wo[e,k,n]
//
// with silu(g) = g / (1 + exp(-g)), as the TPU kernel writes it.
//
// Replaces: src/repro/kernels/moe_gemm.py::grouped_glu_ffn, whose two
// pallas_calls run _glu_kernel (two f32 VMEM accumulators and the SiLU-up
// product in the last-step epilogue) and _proj_kernel over a grid
// (E, C/TC, F/TF, D/TD) with the contraction as the sequential last grid
// axis.  CUDA blocks run in parallel and in no order, so here one block owns
// one (expert, 64-row, 64-column) output tile and loops over the
// contraction itself, with its accumulators in registers; the (E, C, f)
// product g and u never reach device memory, only h does, as on the TPU.
// The TPU wrapper pads x and the weights to tile multiples in device memory
// (_pad_to) because its BlockSpecs need whole tiles; here ragged C, d and f
// are masked inside the tile loads (zero fill) and the stores, so nothing is
// padded or copied.
//
// What bounds it: operations.  At qwen2-moe-a2.7b's width (E=60, d=2048,
// f=1408, C=320) the two kernels do 3.32e11 f32 FLOPs (4.96 ms at 67 TFLOP/s
// on CUDA cores) against 2.61 GB of traffic (0.78 ms at 3.35 TB/s, mostly
// the f32 weights).  The design keeps the FMA units fed from shared memory:
// each thread owns a 4 x 4 register tile (two in moe_glu, one per
// accumulator), so one float4 load of x and one of each weight per step of
// the contraction feed 16 (moe_glu: 32) FMAs; x is staged transposed so that
// load is a float4 too; the next 16-deep slab of x and the weights is loaded
// into registers while the current one is multiplied, and stored into the
// other of two shared-memory buffers, so one barrier per slab suffices.  A
// weight tile is read by the C/64 = 5 blocks of its expert, mostly from L2.
// Tensor cores (TF32/bf16 wgmma) and TMA are left for the PR that makes it
// fast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                 // rows (capacity slots) per block
constexpr int BN = 64;                 // output columns per block
constexpr int BK = 16;                 // contraction depth per slab
constexpr int THREADS = 256;           // 16 x 16 threads
constexpr int TM = 4, TN = 4;          // register tile of one thread
constexpr int LDA = BM + 4;            // row stride of the transposed x slab
constexpr int A_PER_T = BM * BK / THREADS;   // 4 x values a thread loads
constexpr int B_PER_T = BK * BN / THREADS;   // 4 weights (of each) it loads

__device__ __forceinline__ float silu_times(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// out[e] (M x N) = a[e] (M x K) @ b0[e] (K x N), or with GLU
// silu(a[e] @ b0[e]) * (a[e] @ b1[e]).  Row-major, one expert per
// blockIdx.z.
template <bool GLU>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b0,
                    const float* __restrict__ b1, float* __restrict__ out,
                    int M, int N, int K) {
  constexpr int NB = GLU ? 2 : 1;
  __shared__ __align__(16) float As[2][BK][LDA];       // transposed: [k][m]
  __shared__ __align__(16) float Bs[2][NB][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const size_t e = blockIdx.z;
  const float* ae = a + e * M * K;
  const float* be[NB];
  be[0] = b0 + e * K * N;
  if (GLU) be[NB - 1] = b1 + e * K * N;

  float ra[A_PER_T], rb[NB][B_PER_T];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int idx = tid + i * THREADS;
      const int gm = m0 + idx / BK, gk = k0 + idx % BK;
      ra[i] = (gm < M && gk < K) ? ae[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) {
      const int idx = tid + i * THREADS;
      const int gk = k0 + idx / BN, gn = n0 + idx % BN;
      const bool ok = gk < K && gn < N;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        rb[j][i] = ok ? be[j][(size_t)gk * N + gn] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int idx = tid + i * THREADS;
      As[buf][idx % BK][idx / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) {
      const int idx = tid + i * THREADS;
#pragma unroll
      for (int j = 0; j < NB; ++j) Bs[buf][j][idx / BN][idx % BN] = rb[j][i];
    }
  };

  float acc[NB][TM][TN];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[j][r][c] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);     // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[cur][kk][ty * TM]);
      const float am[TM] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&Bs[cur][j][kk][tx * TN]);
        const float bn[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[j][r][c] = fmaf(am[r], bn[c], acc[j][r][c]);
      }
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  float* oe = out + e * M * N;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + ty * TM + r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn = n0 + tx * TN + c;
      if (gn < N)
        oe[(size_t)gm * N + gn] =
            GLU ? silu_times(acc[0][r][c], acc[NB - 1][r][c]) : acc[0][r][c];
    }
  }
}

bool bad_sizes(int E, int M, int N, int K) {
  return E < 1 || E > 65535 || M < 1 || N < 1 || K < 1 ||
         (M + BM - 1) / BM > 65535;
}

}  // namespace

// Kernel 1.  x (E, C, d), wg and wu (E, d, f) -> h (E, C, f), f32.
// Returns cudaGetLastError().
extern "C" int moe_glu(const float* x, const float* wg, const float* wu,
                       float* h, int E, int C, int d, int f, void* stream) {
  if (bad_sizes(E, C, f, d)) return (int)cudaErrorInvalidValue;
  const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  grouped_gemm_kernel<true><<<grid, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, wg, wu, h, C, f, d);
  return (int)cudaGetLastError();
}

// Kernel 2.  h (E, C, f), wo (E, f, d) -> y (E, C, d), f32.  Returns
// cudaGetLastError().
extern "C" int moe_proj(const float* h, const float* wo, float* y, int E,
                        int C, int f, int d, void* stream) {
  if (bad_sizes(E, C, d, f)) return (int)cudaErrorInvalidValue;
  const dim3 grid((d + BN - 1) / BN, (C + BM - 1) / BM, E);
  grouped_gemm_kernel<false><<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      h, wo, nullptr, y, C, d, f);
  return (int)cudaGetLastError();
}
