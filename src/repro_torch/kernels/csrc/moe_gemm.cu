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
// one (expert, BM-row, BN-column) output tile and loops over the
// contraction itself, with its accumulators in registers; the (E, C, f)
// products g and u never reach device memory, only h does, as on the TPU.
// The TPU wrapper pads x and the weights to tile multiples in device memory
// (_pad_to); here ragged C, d and f are zero-filled in the tile copies and
// masked in the stores, so nothing is padded or copied.
//
// What bounds it: operations.  At qwen2-moe-a2.7b's width (E=60, d=2048,
// f=1408, C=320) the two kernels do 3.32e11 FLOPs against 2.39 GB of
// traffic (0.71 ms at 3.35 TB/s, mostly the f32 weights).  On the CUDA
// cores that is 4.96 ms at 67 TFLOP/s, and feeding them from shared memory
// costs more (a float4 load is four wavefronts).  So the products run on
// the tensor cores in TF32, which keeps 10 mantissa bits, too few to be
// sure of the f32 bar (1e-5 of the sum of |terms| against f64).  Each f32
// operand is split where its fragment is loaded into registers, hi =
// tf32(a) and lo = tf32(a - hi) (round to nearest, ties away, as
// cvt.rna.tf32.f32, done in integer operations), so a*b = hi*hi + hi*lo +
// lo*hi + lo*lo, and lo*lo (2^-22 |a||b|) is dropped; the three products run
// as warp-level mma.sync m16n8k8 TF32 instructions, small terms first, into
// f32 accumulators in registers.  Three TF32 passes at 495 TFLOP/s bound
// the call at 2.01 ms.  mma.sync takes both fragments from registers,
// filled by plain 32-bit loads from padded tiles (row stride BK + 4 for x
// or h, BN + 8 for the weights: every fragment load is one conflict-free
// wavefront), so the N-major weights are the B operand as they lie, with
// no transpose; wgmma at TF32 would need both shared operands K-major.
// Tiles arrive through a ring of STAGES asynchronous copies (16-byte
// cp.async.cg where the rows are whole 16-byte vectors, 4-byte copies
// otherwise), so loads overlap the products.  8 warps; each owns 32 rows
// (two m16 tiles) and BN / WARPS_N columns of the block tile.  The
// fragment loads and the splits, done by every warp that reads a value,
// take about as long as the MMAs, and a block's warps are few (one or two
// blocks an SM), so the MMAs run well below their peak.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32mma::cp_async;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait;
using tf32mma::mma_tf32;
using tf32mma::split_tf32;

constexpr int STAGES = 4;              // copies in flight
constexpr int THREADS = 256;           // 8 warps

__device__ __forceinline__ float silu_times(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// The block tile: BM = 64 rows (32 per warp row) by BN = 128 columns; NB
// weight matrices (2 for the GLU: g and u share x's fragments).  The GLU's
// stages are BK = 16 deep, so two of its blocks fit on an SM (at most 128
// registers a thread); the projection's are 32 deep.
template <bool GLU>
struct Tile {
  static constexpr int NB = GLU ? 2 : 1;
  static constexpr int BK = GLU ? 16 : 32;     // contraction depth a stage
  static constexpr int LDA = BK + 4;           // row stride of the x / h tile
  static constexpr int BM = 64, BN = 128;
  static constexpr int WM = 32;                // a warp's rows
  static constexpr int MT = WM / 16;           // its m16 tiles
  static constexpr int WARPS_M = BM / WM, WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N;      // a warp's columns
  static constexpr int NT = WN / 8;            // its n8 tiles
  static constexpr int LDB = BN + 8;           // row stride of a weight tile
  static constexpr int A_FLOATS = BM * LDA;
  static constexpr int B_FLOATS = BK * LDB;
  static constexpr int STAGE_FLOATS = A_FLOATS + NB * B_FLOATS;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * (int)sizeof(float);
};

// out[e] (M x N) = a[e] (M x K) @ b0[e] (K x N), or with GLU
// silu(a[e] @ b0[e]) * (a[e] @ b1[e]).  Row-major, one expert per
// blockIdx.z.  VEC: K and N are multiples of 4 and the pointers 16-byte
// aligned, so every tile row is copied as whole 16-byte vectors.
template <bool GLU, bool VEC>
__device__ __forceinline__ void split_tf32_gemm(const float* __restrict__ a,
                                                const float* __restrict__ b0,
                                                const float* __restrict__ b1,
                                                float* __restrict__ out,
                                                int M, int N, int K) {
  using T = Tile<GLU>;
  constexpr int NB = T::NB, BM = T::BM, BN = T::BN, NT = T::NT, LDB = T::LDB;
  constexpr int BK = T::BK, LDA = T::LDA, MT = T::MT;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;          // fragment row / column
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const size_t e = blockIdx.z;
  const float* ae = a + e * M * K;
  const float* be[NB];
  be[0] = b0 + e * K * N;
  if (GLU) be[NB - 1] = b1 + e * K * N;

  // Copy stage kt of the contraction into ring slot s: the (BM, BK) slab
  // of a and the (BK, BN) slabs of the weights, zeros outside the arrays.
  auto load = [&](int s, int kt) {
    float* as = smem + s * T::STAGE_FLOATS;
    const int k0 = kt * BK;
    if (VEC) {
      for (int c = tid; c < BM * BK / 4; c += THREADS) {
        const int r = c / (BK / 4), k = 4 * (c % (BK / 4));
        const bool ok = m0 + r < M && k0 + k < K;
        cp_async<16>(as + r * LDA + k,
                     ok ? ae + (size_t)(m0 + r) * K + k0 + k : ae, ok);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
        for (int c = tid; c < BK * BN / 4; c += THREADS) {
          const int r = c / (BN / 4), n = 4 * (c % (BN / 4));
          const bool ok = k0 + r < K && n0 + n < N;
          cp_async<16>(as + T::A_FLOATS + j * T::B_FLOATS + r * LDB + n,
                       ok ? be[j] + (size_t)(k0 + r) * N + n0 + n : be[j],
                       ok);
        }
    } else {
      for (int c = tid; c < BM * BK; c += THREADS) {
        const int r = c / BK, k = c % BK;
        const bool ok = m0 + r < M && k0 + k < K;
        cp_async<4>(as + r * LDA + k,
                    ok ? ae + (size_t)(m0 + r) * K + k0 + k : ae, ok);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
        for (int c = tid; c < BK * BN; c += THREADS) {
          const int r = c / BN, n = c % BN;
          const bool ok = k0 + r < K && n0 + n < N;
          cp_async<4>(as + T::A_FLOATS + j * T::B_FLOATS + r * LDB + n,
                      ok ? be[j] + (size_t)(k0 + r) * N + n0 + n : be[j],
                      ok);
        }
    }
  };

  float acc[NB][MT][NT][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][mt][nt][r] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();                 // stage kt has landed
    __syncthreads();                             // and slot kt-1 is free
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES,
                                   kt + STAGES - 1);
    cp_async_commit();
    const float* as = smem + (kt % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + T::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ap = as + (wm * T::WM + mt * 16 + g) * LDA + kk + t;
        split_tf32(ap[0], ahi[mt][0], alo[mt][0]);
        split_tf32(ap[8 * LDA], ahi[mt][1], alo[mt][1]);
        split_tf32(ap[4], ahi[mt][2], alo[mt][2]);
        split_tf32(ap[8 * LDA + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* bp =
              bs + j * T::B_FLOATS + (kk + t) * LDB + wn * T::WN + nt * 8 + g;
          unsigned bhi[2], blo[2];
          split_tf32(bp[0], bhi[0], blo[0]);
          split_tf32(bp[4 * LDB], bhi[1], blo[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(acc[j][mt][nt], alo[mt], bhi);
            mma_tf32(acc[j][mt][nt], ahi[mt], blo);
            mma_tf32(acc[j][mt][nt], ahi[mt], bhi);
          }
        }
    }
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, columns 2t, 2t+1) of an m16n8 tile, c2, c3 at row g+8
  float* oe = out + e * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm * T::WM + mt * 16 + g + 8 * half;
      if (gm >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int gn = n0 + wn * T::WN + nt * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* p = acc[0][mt][nt];
          v[c] = GLU ? silu_times(p[2 * half + c],
                                  acc[NB - 1][mt][nt][2 * half + c])
                     : p[2 * half + c];
        }
        float* o = oe + (size_t)gm * N + gn;
        if (VEC && gn + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        } else {
          if (gn < N) o[0] = v[0];
          if (gn + 1 < N) o[1] = v[1];
        }
      }
    }
}

// The two kernels: the GLU at two blocks an SM, the projection at one.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
glu_kernel(const float* a, const float* b0, const float* b1, float* out,
           int M, int N, int K) {
  split_tf32_gemm<true, VEC>(a, b0, b1, out, M, N, K);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
proj_kernel(const float* a, const float* b0, const float* b1, float* out,
            int M, int N, int K) {
  split_tf32_gemm<false, VEC>(a, b0, b1, out, M, N, K);
}

bool bad_sizes(int E, int M, int N, int K) {
  return E < 1 || E > 65535 || M < 1 || N < 1 || K < 1 ||
         (M + 63) / 64 > 65535;
}

template <bool GLU, bool VEC>
int launch_tile(const float* a, const float* b0, const float* b1, float* out,
                int E, int M, int N, int K, cudaStream_t stream) {
  using T = Tile<GLU>;
  auto kernel = GLU ? glu_kernel<VEC> : proj_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, E);
  kernel<<<grid, THREADS, T::SMEM, stream>>>(a, b0, b1, out, M, N, K);
  return (int)cudaGetLastError();
}

template <bool GLU>
int launch_gemm(const float* a, const float* b0, const float* b1, float* out,
                int E, int M, int N, int K, void* stream) {
  if (bad_sizes(E, M, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b0) |
                    reinterpret_cast<uintptr_t>(GLU ? b1 : b0) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? launch_tile<GLU, true>(a, b0, b1, out, E, M, N, K, s)
             : launch_tile<GLU, false>(a, b0, b1, out, E, M, N, K, s);
}

}  // namespace

// Kernel 1.  x (E, C, d), wg and wu (E, d, f) -> h (E, C, f), f32.
// Returns the first CUDA error, if any.
extern "C" int moe_glu(const float* x, const float* wg, const float* wu,
                       float* h, int E, int C, int d, int f, void* stream) {
  return launch_gemm<true>(x, wg, wu, h, E, C, f, d, stream);
}

// Kernel 2.  h (E, C, f), wo (E, f, d) -> y (E, C, d), f32.  Returns the
// first CUDA error, if any.
extern "C" int moe_proj(const float* h, const float* wo, float* y, int E,
                        int C, int f, int d, void* stream) {
  return launch_gemm<false>(h, wo, nullptr, y, E, C, d, f, stream);
}
