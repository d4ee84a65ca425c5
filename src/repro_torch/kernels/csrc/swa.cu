// Sliding-window causal attention for Hopper (sm_90a), f32 in and out,
// flash style on the tensor cores:
//
//   out[i] = sum_j softmax_j(scale * q_i . k_j) v_j   over  i - window < j <= i
//
// with the softmax taken online over key tiles in f32 (running row max m,
// running sum l, accumulator rescaled by exp(m_old - m_new)).
//
// Replaces: src/repro/kernels/swa.py::swa_attention, whose Pallas body
// _swa_kernel runs a grid (BH, T/TQ, n_win) whose last axis has a constant
// length, so its index map clamps out-of-range key tiles onto in-range ones
// and the kernel drops those aliases (in_range).  Here one block owns one
// (head, 64-query tile) and loops over exactly the 32-key tiles that
// overlap [q0 - window + 1, q0 + 63]; nothing is clamped, aliased or
// dropped.
//
// What bounds it: operations.  At gemma3-4b's local layers (BH = 16,
// T = 8192, d = 256, window 1024) the 1.26e8 visible (query, key) pairs cost
// 4 d FLOPs each, 1.29e11 in all, against 537 MB of traffic (0.160 ms).
// Both products, S = q k^T and o += p v, run on the tensor cores as
// warp-level mma.sync m16n8k8 TF32 instructions into f32 accumulators.  One
// TF32 product keeps 10 mantissa bits, and a score summed over d = 256 such
// products is ~1e-3 off, above the f32 bar (1e-4), so each f32 operand is
// split into hi = tf32(a) and lo = tf32(a - hi) and each product is the
// three TF32 products lo*hi + hi*lo + hi*hi, small terms first
// (tf32_mma.cuh, as moe_gemm.cu does): 3 x 1.29e11 FLOPs at 495 TFLOP/s
// bound the call at 0.781 ms (1.923 ms for one f32 pass on the CUDA cores).
//
// The split is integer work that rivals the MMAs, so each value is split as
// few times as the tiling allows: q once per block, into hi and lo tiles in
// shared memory (2 x 66.5 KB at d = 256), p once, by the thread that
// computes it, and k and v where their fragments are loaded (each k value
// by two warps, each v value by one).  8 warps.  For S, warp (rh, kh, dh)
// owns 32 query rows x 16 keys over one half of d; the two halves' partial
// scores meet in a shared tile, where four threads a row take the online
// softmax (max and sum by shuffles) and store p split.  For o, warp w owns
// all 64 rows x 32 output columns, so p's fragments are read from shared
// memory and v's come from its tile as it lies ([key][column], stride
// = 8 mod 16 words: conflict-free B fragments).  The key and value tiles
// (32 rows) alternate through 16-byte cp.async copies: the value tile lands
// while the scores are computed, the next key tile while the softmax and
// o += p v run.  Columns of d beyond a multiple of 8 are zero in every tile,
// so the last k-step of a ragged d adds zeros.  About 214 KB of shared
// memory at d = 256: one block an SM; the 64 x 32 output accumulator of a
// warp is 64 registers a thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32mma::cp_async;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait;
using tf32mma::mma_split3;
using tf32mma::split_tf32;

constexpr int BQ = 64;              // queries per block
constexpr int BKV = 32;             // keys per tile
constexpr int THREADS = 256;        // 8 warps
constexpr int LDP = BKV + 4;        // row stride of the score / p tiles
constexpr unsigned FULL = 0xffffffffu;

struct Layout {
  int d8, ldq, ldv;                 // d rounded up to 8; row strides
  __host__ __device__ explicit Layout(int d)
      : d8((d + 7) / 8 * 8), ldq(d8 + 4), ldv((d8 + 15) / 16 * 16 + 8) {}
  // floats: q hi, q lo, k, v, two score / p tiles, alpha and l per row
  __host__ __device__ int floats() const {
    return 2 * BQ * ldq + BKV * ldq + BKV * ldv + 2 * BQ * LDP + 2 * BQ;
  }
};

// Rows row0 .. row0 + rows - 1 of one head's (T, d) array into a tile of
// stride ld; rows at or past T are zero-filled (their address is clamped).
__device__ __forceinline__ void load_rows(float* tile, const float* head,
                                          int row0, int rows, int T, int d,
                                          int ld) {
  const int per_row = d / 4;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
    const int row = idx / per_row, c4 = idx % per_row;
    const bool ok = row0 + row < T;
    cp_async<16>(tile + row * ld + 4 * c4,
                 head + (size_t)(ok ? row0 + row : 0) * d + 4 * c4, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
swa_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int T, int d,
           int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(d);
  const int d8 = L.d8, ldq = L.ldq, ldv = L.ldv;
  float* Qs = smem;                          // raw q, then its hi part
  unsigned* Qhi = reinterpret_cast<unsigned*>(Qs);
  unsigned* Qlo = reinterpret_cast<unsigned*>(Qs + BQ * ldq);
  float* Ks = Qs + 2 * BQ * ldq;
  float* Vs = Ks + BKV * ldq;
  float* Sp = Vs + BKV * ldv;                // [2][BQ][LDP]: partial scores,
  unsigned* Phi = reinterpret_cast<unsigned*>(Sp);          // then p's hi
  unsigned* Plo = reinterpret_cast<unsigned*>(Sp + BQ * LDP);  // and lo
  float* alpha_s = Sp + 2 * BQ * LDP;
  float* l_s = alpha_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;      // fragment row / column
  const size_t head = (size_t)blockIdx.y * T * d;
  const int q0 = blockIdx.x * BQ;
  const int lo = max(0, q0 - window + 1);
  const int hi = min(T - 1, q0 + BQ - 1);
  const int kt_lo = lo / BKV, kt_hi = hi / BKV;
  const int nks = d8 / 8, half = (nks + 1) / 2;

  // the scores' warp tile: rows 32 rh.., keys 16 kh.., k-steps of half dh
  const int rh = warp >> 2, kh = (warp >> 1) & 1, dh = warp & 1;
  const int ks_lo = dh * half, ks_hi = min(nks, ks_lo + half);
  // the output's warp tile: all rows, columns 32 warp..
  const int cb = 32 * warp;
  // the softmax's thread: row sr, keys sc0 .. sc0 + 7
  const int sr = tid >> 2, sc0 = (tid & 3) * 8;
  float m_run = -INFINITY, l_run = 0.f;

  float o[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[mt][nt][r] = 0.f;

  load_rows(Qs, q + head, q0, BQ, T, d, ldq);
  load_rows(Ks, k + head, kt_lo * BKV, BKV, T, d, ldq);
  cp_async_commit();
  // columns d .. d8 of the key and value tiles stay zero (never copied)
  for (int idx = tid; idx < BKV * (d8 - d); idx += THREADS) {
    const int row = idx / (d8 - d), col = d + idx % (d8 - d);
    Ks[row * ldq + col] = 0.f;
    Vs[row * ldv + col] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    load_rows(Vs, v + head, k0, BKV, T, d, ldv);
    cp_async_commit();
    cp_async_wait<1>();                      // q and this key tile landed
    __syncthreads();
    if (kt == kt_lo) {                       // split q once, in place
      for (int idx = tid; idx < BQ * d8; idx += THREADS) {
        const int row = idx / d8, col = idx % d8;
        const float a = col < d ? Qs[row * ldq + col] : 0.f;
        split_tf32(a, Qhi[row * ldq + col], Qlo[row * ldq + col]);
      }
      __syncthreads();
    }

    // 1. partial scores of this warp's tile over its half of d
    {
      float acc[2][2][4] = {};
      for (int ks = ks_lo; ks < ks_hi; ++ks) {
        const int kk = 8 * ks + t;
        unsigned ahi[2][4], alo[2][4], bhi[2][2], blo[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = (32 * rh + 16 * mt + g) * ldq + kk;
          ahi[mt][0] = Qhi[r];
          ahi[mt][1] = Qhi[r + 8 * ldq];
          ahi[mt][2] = Qhi[r + 4];
          ahi[mt][3] = Qhi[r + 8 * ldq + 4];
          alo[mt][0] = Qlo[r];
          alo[mt][1] = Qlo[r + 8 * ldq];
          alo[mt][2] = Qlo[r + 4];
          alo[mt][3] = Qlo[r + 8 * ldq + 4];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* kp = Ks + (16 * kh + 8 * nt + g) * ldq + kk;
          split_tf32(kp[0], bhi[nt][0], blo[nt][0]);
          split_tf32(kp[4], bhi[nt][1], blo[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_split3(acc[mt][nt], ahi[mt], alo[mt], bhi[nt], blo[nt]);
      }
      float* part = Sp + dh * BQ * LDP;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = 32 * rh + 16 * mt + g, c = 16 * kh + 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(part + r * LDP + c) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(part + (r + 8) * LDP + c) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
    }
    __syncthreads();                         // Ks is free, Sp complete
    if (kt < kt_hi) load_rows(Ks, k + head, k0 + BKV, BKV, T, d, ldq);
    cp_async_commit();                       // (empty on the last tile)

    // 2. online softmax over this tile: four threads a row, 8 keys each
    {
      const int i = q0 + sr;
      float s[8];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 a =
            *reinterpret_cast<const float4*>(Sp + sr * LDP + sc0 + e);
        const float4 b = *reinterpret_cast<const float4*>(
            Sp + BQ * LDP + sr * LDP + sc0 + e);
        s[e] = a.x + b.x;
        s[e + 1] = a.y + b.y;
        s[e + 2] = a.z + b.z;
        s[e + 3] = a.w + b.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = k0 + sc0 + e;
        const bool seen = i < T && j <= i && j > i - window;
        s[e] = seen ? s[e] * scale : -INFINITY;
        mx = fmaxf(mx, s[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      // a row with nothing seen yet keeps p = 0 and alpha = 0 (exp(-inf))
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run - m_use);
      float sum = 0.f;
      unsigned phi[8], plo[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float p = expf(s[e] - m_use);
        sum += p;
        split_tf32(p, phi[e], plo[e]);
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        *reinterpret_cast<uint4*>(Phi + sr * LDP + sc0 + e) =
            make_uint4(phi[e], phi[e + 1], phi[e + 2], phi[e + 3]);
        *reinterpret_cast<uint4*>(Plo + sr * LDP + sc0 + e) =
            make_uint4(plo[e], plo[e + 1], plo[e + 2], plo[e + 3]);
      }
      if ((tid & 3) == 0) alpha_s[sr] = alpha;
    }
    cp_async_wait<1>();                      // this value tile landed
    __syncthreads();

    // 3. o = alpha o + p v over this warp's 32 columns
    if (cb < d) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float a0 = alpha_s[16 * mt + g], a1 = alpha_s[16 * mt + g + 8];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          o[mt][nt][0] *= a0;
          o[mt][nt][1] *= a0;
          o[mt][nt][2] *= a1;
          o[mt][nt][3] *= a1;
        }
      }
#pragma unroll
      for (int ks = 0; ks < BKV / 8; ++ks) {
        unsigned ahi[4][4], alo[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r = (16 * mt + g) * LDP + 8 * ks + t;
          ahi[mt][0] = Phi[r];
          ahi[mt][1] = Phi[r + 8 * LDP];
          ahi[mt][2] = Phi[r + 4];
          ahi[mt][3] = Phi[r + 8 * LDP + 4];
          alo[mt][0] = Plo[r];
          alo[mt][1] = Plo[r + 8 * LDP];
          alo[mt][2] = Plo[r + 4];
          alo[mt][3] = Plo[r + 8 * LDP + 4];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (cb + 8 * nt >= d) break;
          const float* vp = Vs + (8 * ks + t) * ldv + cb + 8 * nt + g;
          unsigned bhi[2], blo[2];
          split_tf32(vp[0], bhi[0], blo[0]);
          split_tf32(vp[4 * ldv], bhi[1], blo[1]);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            mma_split3(o[mt][nt], ahi[mt], alo[mt], bhi, blo);
        }
      }
    }
    __syncthreads();                         // Vs, Sp and alpha are free
  }
  cp_async_wait<0>();

  if ((tid & 3) == 0) l_s[sr] = l_run;
  __syncthreads();
  if (cb >= d) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h, i = q0 + r;
      if (i >= T) continue;
      const float inv = 1.f / fmaxf(l_s[r], 1e-20f);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = cb + 8 * nt + 2 * t;
        if (col < d)
          *reinterpret_cast<float2*>(out + head + (size_t)i * d + col) =
              make_float2(o[mt][nt][2 * h] * inv, o[mt][nt][2 * h + 1] * inv);
      }
    }
}

}  // namespace

// q, k, v (BH, T, d) -> out (BH, T, d), f32; 4 <= d <= 256 with d % 4 == 0,
// window >= 1.  Returns the first CUDA error, if any.
extern "C" int swa_forward(const float* q, const float* k, const float* v,
                           float* out, int BH, int T, int d, int window,
                           float scale, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1 || d < 4 || d > 256 || d % 4 != 0 ||
      window < 1)
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(float) * Layout(d).floats();
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, BH);
  swa_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, T, d, window, scale);
  return (int)cudaGetLastError();
}
