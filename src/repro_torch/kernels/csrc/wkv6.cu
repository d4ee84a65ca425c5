// Chunked RWKV-6 ("Finch") recurrence for Hopper (sm_90a), f32.
//
// Per head (S = state (dk, dv), w = decay in (0, 1], u = bonus):
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t
// computed chunk by chunk with the TPU kernel's formula: with
// lw = log(clip(w, 1e-6, 1)) and cum_t = sum_{s<=t} lw_s inside a chunk of c
// tokens,
//   qp_t = r_t * exp(cum_t - lw_t)                 kp_s = k_s * exp(-cum_s)
//   a[t][s] = qp_t . kp_s (s < t),  (r_t * u) . k_t (s = t),  0 (s > t)
//   o = a v + qp S
//   S <- diag(exp(cum_c)) S + (k * exp(cum_c - cum))^T v
// Here exp(cum_t) is taken as the running product P_t = prod_{s<=t}
// clip(w_s, 1e-6, 1), so qp = r * P_{t-1}, kp = k / P_t and the update's
// factors are P_c / P_t and P_c: the same quantities with no log or exp,
// each within a few ulp of the TPU kernel's.
//
// Stability domain: the factors are chunk-local and reach 1 / w^c; f32
// overflows past 3.4e38 (e^88), so the formula holds for w >= 0.55 at
// c = 64 (the TPU kernel's documented domain) and for the model's whole
// range w >= exp(-e) = 0.066 at c = 16 (models/rwkv.py, launch/serve.py).
// Outside it kp overflows to inf and the output is NaN, in the JAX kernel
// too.
//
// Replaces: src/repro/kernels/wkv6.py::wkv6_chunked, whose Pallas body
// _wkv6_kernel runs a grid (BH, T/C) with the chunk axis in sequence and the
// state carried in VMEM scratch.  Run that way, a CUDA block walks its
// head's chunks one after another and waits on each chunk's loads, scans
// and products.  Here only the state's recurrence walks the chunks in
// order; the outputs, which hold most of the work, take every chunk of
// every head in parallel.  Two kernels:
//   1. wkv6_state_kernel, one block per (head, 64 value columns), walks
//      the chunks: S_n = diag(exp(cum_c)) S_{n-1} + (k * exp(cum_c - cum))^T
//      v, the state in registers; half the block scans chunk n while the
//      other half multiplies chunk n - 1 and chunk n + 1 is copied
//      (16-byte cp.async, three stages); it writes the state entering
//      every chunk to a scratch array, and S_T.
//   2. wkv6_out_kernel, one block per (chunk n, head, 64 value columns):
//      o = a v + qp S_{n-1}, 8,192 independent blocks at full width.
// The cumulative decay is one thread per (channel, 16 tokens; 32 in
// kernel 1): a serial product, then the segments' totals joined by warp
// shuffles; the bonus diag_t is one warp a token, summed by shuffles.  The
// [token][channel] tiles of r, k and w are stored with channel groups of 8
// swizzled by the token's 16-row band, so the scan's accesses (four bands
// of one channel group in one warp) and the MMA fragment loads are
// conflict-free.  Kernel 2 takes its tiles by 16-byte cp.async copies
// (4-byte where dk or dv is not a multiple of 4) while its decays are read
// into registers, three blocks an SM, so one block's copies overlap the
// others' products; its three products (a = qp kp^T, a v, qp S) run on the
// tensor cores as mma.sync m16n8k8 TF32 instructions with each f32 operand
// split into hi and lo and three products summed (tf32_mma.cuh): 2^-22
// relative a product, where one TF32 pass is not inside the 3e-4 bar.  The
// tiles of a above the diagonal are skipped, and a v stops at each row
// block's diagonal.  Kernel 1's product kd^T v runs on the CUDA cores
// (8 x 4 register tiles: two float4 reads of kd and one of v feed 32
// FMAs), overlapped with the scan of the next chunk.
//
// What bounds it: bytes, narrowly.  At rwkv6-7b's width (BH = 128 heads,
// T = 4096, dk = dv = 64, c = 64) the function moves 673 MB (0.201 ms at
// 3.35 TB/s) and needs 12.95 GFLOP (0.193 ms at 67 TFLOP/s on CUDA cores).
// This design moves more: r, k, w and v are read by both kernels (k, w
// and v twice) and the state entering each chunk (134 MB at that width) is
// written and read back, about 1.34 GB in all (0.40 ms).
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

constexpr int CMAX = 64;            // chunk length at most
constexpr int DKMAX = 64;           // key channels at most
constexpr int DVT = 64;             // value columns per block
constexpr int LD = 68;              // row stride of every 64 x 64 tile
constexpr int TILE = CMAX * LD;     // floats of one tile
constexpr int LDB = 72;             // row stride of an MMA B-operand tile
constexpr int BTILE = CMAX * LDB;
constexpr int STAGE = 3 * TILE;     // the state kernel's k, w and v tiles
constexpr int THREADS = 256;        // 16 x 16 threads
constexpr unsigned FULL = 0xffffffffu;

// Column of channel i in row t of a swizzled [token][channel] tile: groups
// of 8 channels XOR the token's 16-row band, so a float4 of 4 channels
// starting at a multiple of 4 stays whole.
__device__ __forceinline__ int swz(int t, int i) {
  return i ^ (((t >> 4) & 3) << 3);
}

// Rows [0, rows) x columns [0, cols) of a row-major array (row stride ld,
// src at element (0, 0)) into a 64 x 64 tile of row stride TLD, zeros
// elsewhere; SWZ swizzles the columns as swz does.  VEC: cols, ld and src
// are whole 16-byte vectors.
template <bool VEC, bool SWZ, int TLD = LD>
__device__ __forceinline__ void copy_tile(float* tile, const float* src,
                                          int rows, int cols, int ld) {
  if (VEC) {
    for (int idx = threadIdx.x; idx < CMAX * DVT / 4; idx += THREADS) {
      const int r = idx / (DVT / 4), c = 4 * (idx % (DVT / 4));
      const bool ok = r < rows && c < cols;
      cp_async<16>(tile + r * TLD + (SWZ ? swz(r, c) : c),
                   ok ? src + (size_t)r * ld + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < CMAX * DVT; idx += THREADS) {
      const int r = idx / DVT, c = idx % DVT;
      const bool ok = r < rows && c < cols;
      cp_async<4>(tile + r * TLD + (SWZ ? swz(r, c) : c),
                  ok ? src + (size_t)r * ld + c : src, ok);
    }
  }
}

// The split A fragment (rows row and row + 8, columns col and col + 4) of
// a swizzled [token][channel] tile; the two rows share a 16-row band.
__device__ __forceinline__ void load_a_swz(const float* tile, int row, int col,
                                           unsigned* hi, unsigned* lo) {
  const float* p = tile + row * LD;
  const int band = ((row >> 4) & 3) << 3;
  split_tf32(p[col ^ band], hi[0], lo[0]);
  split_tf32(p[8 * LD + (col ^ band)], hi[1], lo[1]);
  split_tf32(p[(col + 4) ^ band], hi[2], lo[2]);
  split_tf32(p[8 * LD + ((col + 4) ^ band)], hi[3], lo[3]);
}

// acc[nt] += a * B over four n8 tiles of a row-major [k][n] tile of stride
// LDB, bp at B[tq][g] of the first tile; B's split fragments are loaded
// here, a's are given.
__device__ __forceinline__ void mma_row_b(float (&acc)[4][4],
                                          const unsigned* ahi,
                                          const unsigned* alo,
                                          const float* bp) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    unsigned bhi[2], blo[2];
    split_tf32(bp[8 * nt], bhi[0], blo[0]);
    split_tf32(bp[4 * LDB + 8 * nt], bhi[1], blo[1]);
    mma_split3(acc[nt], ahi, alo, bhi, blo);
  }
}

// The cumulative decay P_t = prod_{s<=t} clip(w_s, 1e-6, 1) = exp(cum_t)
// of one channel, split over SEGS adjacent lanes (seg = lane % SEGS), each
// holding L = 64 / SEGS tokens, L * seg .. L * seg + L - 1: wv holds the
// segment's decays on entry (1 past the chunk) and clipped on exit.  P_t
// of the lane's q-th token is excl * (wv[0] * .. * wv[q]), with excl the
// product of the earlier segments' totals, which this returns; p_c is P at
// token c - 1, as the lane that owns that token computes it.
template <int SEGS>
__device__ __forceinline__ float chunk_decay(float (&wv)[CMAX / SEGS], int c,
                                             int seg, float& p_c) {
  constexpr int L = CMAX / SEGS;
  float run = 1.f, run_c = 1.f;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    wv[q] = fminf(fmaxf(wv[q], 1e-6f), 1.f);
    run *= wv[q];
    if (L * seg + q == c - 1) run_c = run;
  }
  // inclusive prefix of the segments' totals, then its shift by one
  float x = run;
#pragma unroll
  for (int d = 1; d < SEGS; d *= 2) {
    const float y = __shfl_up_sync(FULL, x, d, SEGS);
    if (seg >= d) x *= y;
  }
  const float y = __shfl_up_sync(FULL, x, 1, SEGS);
  const float excl = seg >= 1 ? y : 1.f;
  p_c = __shfl_sync(FULL, excl * run_c, (c - 1) / L, SEGS);
  return excl;
}

// The segment's decays w[t][i] for the scan, 1 outside the chunk.
__device__ __forceinline__ void load_decays(float (&wv)[16],
                                            const float* __restrict__ w,
                                            size_t row0, int c, int dk, int i,
                                            int seg) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int t = 16 * seg + q;
    wv[q] = t < c && i < dk ? w[(row0 + t) * dk + i] : 1.f;
  }
}

// Kernel 1: the state entering every chunk, for one (head, column tile),
// walking the chunks in order: S_n = diag(exp(cum_c)) S_{n-1} + kd^T v with
// kd = k * exp(cum_c - cum).  The block's halves work on two chunks at
// once: while warps 4-7 scan chunk n (cum, kd and exp(cum_c)), warps 0-3
// multiply chunk n - 1 (kd^T v on the CUDA cores, 8 x 4 register tiles:
// two float4 reads of kd and one of v feed 32 FMAs) and update the state,
// which they hold in registers (rows i = 8 ty + a, columns j = 4 tx + e);
// chunk n + 1's k, w and v are copied meanwhile, three stages in all.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_state_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ w, float* __restrict__ states,
                  float* __restrict__ sfin, int T, int dk, int dv, int c,
                  int dvp) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem + 3 * STAGE;              // exp(cum_c) per channel, x2
  const int tid = threadIdx.x, nch = T / c;
  const size_t bh = blockIdx.x;
  const int j0 = blockIdx.y * DVT;
  // a chunk's tiles: k (then kd) and w, swizzled; the value column tile
  auto load = [&](int n) {
    float* b = smem + (n % 3) * STAGE;
    const size_t row0 = bh * T + (size_t)n * c;
    copy_tile<VEC, true>(b, k + row0 * dk, c, dk, dk);
    copy_tile<VEC, true>(b + TILE, w + row0 * dk, c, dk, dk);
    copy_tile<VEC, false>(b + 2 * TILE, v + row0 * dv + j0, c, dv - j0, dv);
  };
  const bool scans = tid >= THREADS / 2;
  const int tb = tid - THREADS / 2;          // the scanning half's thread
  const int i = tb >> 1, seg = tb & 1;
  const int tx = tid & 15, ty = (tid >> 4) & 7;
  float S[8][4] = {};
  load(0);
  cp_async_commit();
  for (int it = 0; it <= nch; ++it) {
    cp_async_wait<0>();                      // chunk it has landed
    __syncthreads();                         // chunk it - 2 is done
    if (it + 1 < nch) load(it + 1);
    cp_async_commit();
    if (scans) {
      if (it < nch) {
        float* Ks = smem + (it % 3) * STAGE;
        const float* Ws = Ks + TILE;
        float wv[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const int t = 32 * seg + q;
          wv[q] = t < c && i < dk ? Ws[t * LD + swz(t, i)] : 1.f;
        }
        float p_c;
        const float excl = chunk_decay<2>(wv, c, seg, p_c);
        if (i < dk) {
          float run = 1.f;
#pragma unroll
          for (int q = 0; q < 32; ++q) {
            const int t = 32 * seg + q;
            run *= wv[q];
            if (t < c) Ks[t * LD + swz(t, i)] *= p_c / (excl * run);
          }
          if (seg == 0) gs[(it & 1) * CMAX + i] = p_c;
        }
      }
    } else if (it > 0) {
      const int n = it - 1;
      const float* Ks = smem + (n % 3) * STAGE;
      const float* Vs = Ks + 2 * TILE;
      float acc[8][4] = {};
      for (int t = 0; t < c; ++t) {
        const float* kr = Ks + t * LD + swz(t, 8 * ty);
        const float4 k0 = *reinterpret_cast<const float4*>(kr);
        const float4 k1 = *reinterpret_cast<const float4*>(kr + 4);
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + t * LD + 4 * tx);
        const float km[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          acc[a][0] = fmaf(km[a], vv.x, acc[a][0]);
          acc[a][1] = fmaf(km[a], vv.y, acc[a][1]);
          acc[a][2] = fmaf(km[a], vv.z, acc[a][2]);
          acc[a][3] = fmaf(km[a], vv.w, acc[a][3]);
        }
      }
      const float* g = gs + (n & 1) * CMAX;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int row = 8 * ty + a;
        if (row >= dk) break;
        *reinterpret_cast<float4*>(
            states + ((bh * nch + n) * dk + row) * dvp + j0 + 4 * tx) =
            make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) S[a][e] = g[row] * S[a][e] + acc[a][e];
      }
    }
  }
  cp_async_wait<0>();
  if (scans) return;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = 8 * ty + a, j = j0 + 4 * tx;
    if (row >= dk) break;
    float* dst = sfin + (bh * dk + row) * dv + j;
    if (VEC && j + 3 < dv) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < dv) dst[e] = S[a][e];
    }
  }
}

// Kernel 2: o = a v + qp S_{n-1} for one (chunk, head, column tile).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
wkv6_out_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u,
                const float* __restrict__ states, float* __restrict__ out,
                int T, int dk, int dv, int c, int dvp) {
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                  // r, then qp (swizzled)
  float* Ks = Rs + TILE;             // k, then kp (swizzled), then a
  float* Vs = Ks + TILE;             // the value column tile, [t][j]
  float* Ss = Vs + BTILE;            // the state entering the chunk, [i][j]
  float* diag = Ss + BTILE;          // (r_t * u) . k_t
  float* us = diag + CMAX;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x, nch = gridDim.x;
  const size_t bh = blockIdx.y;
  const int j0 = blockIdx.z * DVT;
  const size_t row0 = bh * T + (size_t)n * c;
  copy_tile<VEC, true>(Rs, r + row0 * dk, c, dk, dk);
  copy_tile<VEC, true>(Ks, k + row0 * dk, c, dk, dk);
  copy_tile<VEC, false, LDB>(Vs, v + row0 * dv + j0, c, dv - j0, dv);
  copy_tile<true, false, LDB>(Ss, states + (bh * nch + n) * dk * dvp + j0,
                              dk, DVT, dvp);
  cp_async_commit();
  if (tid < DKMAX) us[tid] = tid < dk ? u[bh * dk + tid] : 0.f;
  const int i = tid >> 2, seg = tid & 3;
  float wv[16];
  load_decays(wv, w, row0, c, dk, i, seg);
  cp_async_wait<0>();
  __syncthreads();

  // 1. the bonus diag_t, one warp a token, before r and k are scaled
  for (int t = warp; t < CMAX; t += THREADS / 32) {
    float d = 0.f;
    if (t < c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = lane + 32 * h;
        const int col = swz(t, ch);
        d += Rs[t * LD + col] * us[ch] * Ks[t * LD + col];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(FULL, d, off);
    }
    if (lane == 0) diag[t] = d;
  }
  __syncthreads();

  // 2. qp = r * exp(cum - lw) = r * P_{t-1}, kp = k * exp(-cum) = k / P_t,
  // in place
  {
    float p_c;
    const float excl = chunk_decay<4>(wv, c, seg, p_c);
    if (i < dk) {
      float run = 1.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int t = 16 * seg + q;
        const float before = excl * run;
        run *= wv[q];
        if (t < c) {
          const int col = t * LD + swz(t, i);
          Rs[col] *= before;
          Ks[col] /= excl * run;
        }
      }
    }
  }
  __syncthreads();

  // 3. a = qp kp^T (s < t), diag (s = t), 0 (s > t) on the tensor cores:
  // warp (m, nh) owns rows 16 m .. and columns 32 nh .. (four n8 tiles),
  // skipping the tiles wholly above the diagonal
  const int g = lane / 4, tq = lane % 4;     // fragment row / column
  const int m = warp & 3, nh = warp >> 2;
  const int nks = (dk + 7) / 8;              // k-steps over the channels
  const int row_a = 16 * m + g;              // this lane's rows: +0, +8
  {
    float acc[4][4] = {};
    for (int ks = 0; ks < nks; ++ks) {
      unsigned ahi[4], alo[4];
      load_a_swz(Rs, row_a, 8 * ks + tq, ahi, alo);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int s0 = 32 * nh + 8 * nt;
        if (s0 > 16 * m + 15) break;
        const int s = s0 + g, ch = 8 * ks + tq;
        unsigned bhi[2], blo[2];
        split_tf32(Ks[s * LD + swz(s, ch)], bhi[0], blo[0]);
        split_tf32(Ks[s * LD + swz(s, ch + 4)], bhi[1], blo[1]);
        mma_split3(acc[nt], ahi, alo, bhi, blo);
      }
    }
    __syncthreads();                 // every warp is done with kp
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int s0 = 32 * nh + 8 * nt;
      if (s0 > 16 * m + 15) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = row_a + 8 * (e >> 1), s = s0 + 2 * tq + (e & 1);
        Ks[t * LD + s] = s < t ? acc[nt][e] : (s == t ? diag[t] : 0.f);
      }
    }
  }
  __syncthreads();

  // 4. o = a v + qp S on the tensor cores, warp (m, nh) at rows 16 m ..
  // and columns 32 nh ..; a is zero past row 16 m + 15's diagonal, so the
  // a v sum stops at k-step 2 m + 1
  float o[4][4] = {};
  const int av_steps = min(2 * m + 2, (c + 7) / 8);
  for (int ks = 0; ks < av_steps; ++ks) {
    unsigned ahi[4], alo[4];
    const float* ap = Ks + row_a * LD + 8 * ks + tq;
    split_tf32(ap[0], ahi[0], alo[0]);
    split_tf32(ap[8 * LD], ahi[1], alo[1]);
    split_tf32(ap[4], ahi[2], alo[2]);
    split_tf32(ap[8 * LD + 4], ahi[3], alo[3]);
    mma_row_b(o, ahi, alo, Vs + (8 * ks + tq) * LDB + 32 * nh + g);
  }
  for (int ks = 0; ks < nks; ++ks) {
    unsigned ahi[4], alo[4];
    load_a_swz(Rs, row_a, 8 * ks + tq, ahi, alo);
    mma_row_b(o, ahi, alo, Ss + (8 * ks + tq) * LDB + 32 * nh + g);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row_a + 8 * h;
    if (t >= c) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j0 + 32 * nh + 8 * nt + 2 * tq;
      float* dst = out + (row0 + t) * dv + j;
      if (VEC && j + 1 < dv) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
      } else {
        if (j < dv) dst[0] = o[nt][2 * h];
        if (j + 1 < dv) dst[1] = o[nt][2 * h + 1];
      }
    }
  }
}

constexpr int STATE_SMEM = (3 * STAGE + 2 * CMAX) * (int)sizeof(float);
constexpr int OUT_SMEM = (2 * TILE + 2 * BTILE + 2 * CMAX) * (int)sizeof(float);

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool bad_sizes(int BH, int T, int dk, int dv, int c) {
  return BH < 1 || BH > 65535 || T < 1 || dk < 1 || dk > DKMAX || dv < 1 ||
         c < 1 || c > CMAX || T % c != 0 || (dv + DVT - 1) / DVT > 65535;
}

int vec_dims(int dk, int dv) { return dk % 4 == 0 && dv % 4 == 0; }

template <typename K>
cudaError_t raise_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The scratch the two kernels share: states (BH, T / c, dk, dvp) f32, the
// state entering each chunk, with dvp = dv rounded up to 64.

// Kernel 1.  k, w (BH, T, dk), v (BH, T, dv) -> states and sfin (BH, dk,
// dv), the state after the last chunk.  Returns the first CUDA error, if
// any.
extern "C" int wkv6_state(const float* k, const float* v, const float* w,
                          float* states, float* sfin, int BH, int T, int dk,
                          int dv, int c, void* stream) {
  if (bad_sizes(BH, T, dk, dv, c)) return (int)cudaErrorInvalidValue;
  const int dvp = (dv + DVT - 1) / DVT * DVT;
  const bool vec = vec_dims(dk, dv) && aligned16(k) && aligned16(v) &&
                   aligned16(w) && aligned16(sfin);
  auto kernel = vec ? wkv6_state_kernel<true> : wkv6_state_kernel<false>;
  cudaError_t err = raise_smem(kernel, STATE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, dvp / DVT);
  kernel<<<grid, THREADS, STATE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      k, v, w, states, sfin, T, dk, dv, c, dvp);
  return (int)cudaGetLastError();
}

// Kernel 2.  r, k, w (BH, T, dk), v (BH, T, dv), u (BH, dk) and the states
// entering each chunk -> out (BH, T, dv).  Returns the first CUDA error, if
// any.
extern "C" int wkv6_out(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* states,
                        float* out, int BH, int T, int dk, int dv, int c,
                        void* stream) {
  if (bad_sizes(BH, T, dk, dv, c)) return (int)cudaErrorInvalidValue;
  const int dvp = (dv + DVT - 1) / DVT * DVT;
  const bool vec = vec_dims(dk, dv) && aligned16(r) && aligned16(k) &&
                   aligned16(v) && aligned16(out);
  auto kernel = vec ? wkv6_out_kernel<true> : wkv6_out_kernel<false>;
  cudaError_t err = raise_smem(kernel, OUT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(T / c, BH, dvp / DVT);
  kernel<<<grid, THREADS, OUT_SMEM, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, states, out, T, dk, dv, c, dvp);
  return (int)cudaGetLastError();
}
