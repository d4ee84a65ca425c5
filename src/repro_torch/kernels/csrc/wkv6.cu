// Chunked RWKV-6 ("Finch") recurrence for Hopper (sm_90a), f32.
//
// Per head (S = state (dk, dv), w = decay in (0, 1], u = bonus):
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t
// computed chunk by chunk, exactly as the TPU kernel does, with
// lw = log(clip(w, 1e-6, 1)) and cum_t = sum_{s<=t} lw_s inside a chunk of c
// tokens:
//   qp_t = r_t * exp(cum_t - lw_t)                 kp_s = k_s * exp(-cum_s)
//   a[t][s] = qp_t . kp_s (s < t),  (r_t * u) . k_t (s = t),  0 (s > t)
//   o = a v + qp S
//   S <- diag(exp(cum_c)) S + (k * exp(cum_c - cum))^T v
//
// Stability domain: the exponents are chunk-local and reach c * |log w|; the
// f32 exp overflows past 88, so the formula holds for w >= 0.55 at c = 64
// (the TPU kernel's documented domain) and for the model's whole range
// w >= exp(-e) = 0.066 at c = 16 (models/rwkv.py, launch/serve.py).  Outside
// it kp overflows to inf and the output is NaN, in the JAX kernel too.
//
// Replaces: src/repro/kernels/wkv6.py::wkv6_chunked, whose Pallas body
// _wkv6_kernel runs a grid (BH, T/C) with the chunk axis in sequence and the
// state carried in VMEM scratch.  CUDA blocks run in parallel and in no
// order, so here the chunk axis is a loop inside the block and the state
// stays in shared memory for the whole sequence.
//
// What bounds it: bytes, narrowly.  At rwkv6-7b's width (BH = 128 heads,
// T = 4096, dk = dv = 64, c = 64) the function moves 673 MB (0.201 ms at
// 3.35 TB/s) and needs 12.95 GFLOP (0.193 ms at 67 TFLOP/s on CUDA cores):
// per chunk and head the strict lower triangle of a (c(c-1)/2 * dk
// multiply-adds) and its diagonal (c * dk), a v over that triangle
// (c(c+1)/2 * dv), qp S and kd^T v (c * dk * dv each).  This kernel is far
// from either: a block runs its chunks one after another, so it waits on
// each chunk's loads and barriers.  128 heads are fewer than the 132 SMs, so
// the design splits the work over the value columns: o[:, j] and S[:, j]
// read only v[:, j], so one block owns one (head, 32-column tile) and the
// grid has BH * dv / 32 blocks (256 at rwkv6-7b).  The cost of the split:
// each tile recomputes the chunk's c x c matrix a, over the 136 of 256 4 x 4
// tiles on or below the diagonal, so at dv = 64 the two tiles do 1.15x the
// FMAs of one block per head; with a v taken over all c columns, they do
// 1.35x the multiply-adds the function needs.  Each
// thread owns a 4 x 4 (a) or 4 x 2 (o, S) register tile; the chunk's r, k, kp
// and log-decay tiles are stored channel-major ([i][t]) so the a and o
// products read float4s.  About 102 KB of shared memory per block (two
// blocks per SM).  The next chunk is not prefetched while the current one
// is computed; that, tensor cores and a cluster that shares a between the
// column tiles are left for the PR that makes it fast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CMAX = 64;            // chunk length at most
constexpr int DKMAX = 64;           // key channels at most
constexpr int DVT = 32;             // value columns per block
constexpr int LD = CMAX + 4;        // row stride of the [channel][token] tiles
constexpr int THREADS = 256;        // 16 x 16 threads

struct Smem {
  float r[DKMAX][LD];       // r, then qp
  float k[DKMAX][LD];       // k, then kd = k * exp(cum_c - cum)
  float kp[DKMAX][LD];      // k * exp(-cum)
  float lw[DKMAX][LD];      // log decay; then a, stored [s][t]
  float cum[DKMAX][LD];     // inclusive cumulative log decay
  float v[CMAX][DVT];       // the chunk's value tile, [t][j]
  float S[DKMAX][DVT];      // the state's column tile, [i][j]
  float diag[CMAX];         // (r_t * u) . k_t
  float u[DKMAX];
};

__global__ void __launch_bounds__(THREADS, 2)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ out,
            float* __restrict__ sfin, int T, int dk, int dv, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float (*aT)[LD] = sm.lw;           // a[t][s] at aT[s][t], once lw is spent
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t bh = blockIdx.x;
  const int j0 = blockIdx.y * DVT;

  for (int idx = tid; idx < DKMAX * DVT; idx += THREADS)
    sm.S[idx / DVT][idx % DVT] = 0.f;
  for (int i = tid; i < dk; i += THREADS) sm.u[i] = u[bh * dk + i];

  for (int t0 = 0; t0 < T; t0 += c) {
    // 1. the chunk's r, k, log decay (channel-major) and value tile
    const size_t row0 = bh * T + t0;
    for (int idx = tid; idx < c * dk; idx += THREADS) {
      const int t = idx / dk, i = idx % dk;
      const size_t g = (row0 + t) * dk + i;
      sm.r[i][t] = r[g];
      sm.k[i][t] = k[g];
      sm.lw[i][t] = logf(fminf(fmaxf(w[g], 1e-6f), 1.f));
    }
    for (int idx = tid; idx < c * DVT; idx += THREADS) {
      const int t = idx / DVT, j = idx % DVT;
      sm.v[t][j] = j0 + j < dv ? v[(row0 + t) * dv + j0 + j] : 0.f;
    }
    __syncthreads();

    // 2. cumulative log decay per channel; the bonus term per token
    if (tid < dk) {
      float cum = 0.f;
      for (int t = 0; t < c; ++t) {
        cum += sm.lw[tid][t];
        sm.cum[tid][t] = cum;
      }
    } else if (tid >= DKMAX && tid < DKMAX + c) {
      const int t = tid - DKMAX;
      float d = 0.f;
      for (int i = 0; i < dk; ++i) d = fmaf(sm.r[i][t] * sm.u[i], sm.k[i][t], d);
      sm.diag[t] = d;
    }
    __syncthreads();

    // 3. qp, kp and kd
    for (int idx = tid; idx < dk * c; idx += THREADS) {
      const int i = idx / c, t = idx % c;
      const float cm = sm.cum[i][t];
      const float kk = sm.k[i][t];
      sm.r[i][t] *= expf(cm - sm.lw[i][t]);
      sm.kp[i][t] = kk * expf(-cm);
      sm.k[i][t] = kk * expf(sm.cum[i][c - 1] - cm);
    }
    __syncthreads();

    // 4. a: rows t = ty*4.., columns s = tx*4..; tiles wholly above the
    // diagonal are zero and skip the product
    if (ty * 4 < c && tx * 4 < c) {
      float acc[4][4] = {};
      if (tx <= ty) {
        for (int i = 0; i < dk; ++i) {
          const float4 q = *reinterpret_cast<const float4*>(&sm.r[i][ty * 4]);
          const float4 p = *reinterpret_cast<const float4*>(&sm.kp[i][tx * 4]);
          const float qv[4] = {q.x, q.y, q.z, q.w};
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qv[a], pv[b], acc[a][b]);
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int s = tx * 4 + b;
        float col[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int t = ty * 4 + a;
          col[a] = s < t ? acc[a][b] : (s == t ? sm.diag[t] : 0.f);
        }
        *reinterpret_cast<float4*>(&aT[s][ty * 4]) =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
    __syncthreads();

    // 5. o = a v + qp S (S before this chunk's update): rows t = ty*4..,
    // columns j = tx*2..
    if (ty * 4 < c) {
      float oi[4][2] = {}, oe[4][2] = {};
      for (int s = 0; s < c; ++s) {
        const float4 av = *reinterpret_cast<const float4*>(&aT[s][ty * 4]);
        const float2 vv = *reinterpret_cast<const float2*>(&sm.v[s][tx * 2]);
        const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          oi[a][0] = fmaf(am[a], vv.x, oi[a][0]);
          oi[a][1] = fmaf(am[a], vv.y, oi[a][1]);
        }
      }
      for (int i = 0; i < dk; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&sm.r[i][ty * 4]);
        const float2 sv = *reinterpret_cast<const float2*>(&sm.S[i][tx * 2]);
        const float qm[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          oe[a][0] = fmaf(qm[a], sv.x, oe[a][0]);
          oe[a][1] = fmaf(qm[a], sv.y, oe[a][1]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty * 4 + a;
        if (t >= c) break;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int j = j0 + tx * 2 + b;
          if (j < dv) out[(row0 + t) * dv + j] = oi[a][b] + oe[a][b];
        }
      }
    }
    __syncthreads();

    // 6. S <- diag(exp(cum_c)) S + kd^T v: rows i = ty*4.., columns tx*2..
    if (ty * 4 < dk) {
      float acc[4][2] = {};
      for (int s = 0; s < c; ++s) {
        const float2 vv = *reinterpret_cast<const float2*>(&sm.v[s][tx * 2]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float kd = sm.k[ty * 4 + a][s];
          acc[a][0] = fmaf(kd, vv.x, acc[a][0]);
          acc[a][1] = fmaf(kd, vv.y, acc[a][1]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
        if (i >= dk) break;
        const float decay = expf(sm.cum[i][c - 1]);
        sm.S[i][tx * 2] = decay * sm.S[i][tx * 2] + acc[a][0];
        sm.S[i][tx * 2 + 1] = decay * sm.S[i][tx * 2 + 1] + acc[a][1];
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < dk * DVT; idx += THREADS) {
    const int i = idx / DVT, j = idx % DVT;
    if (j0 + j < dv) sfin[(bh * dk + i) * dv + j0 + j] = sm.S[i][j];
  }
}

}  // namespace

// r, k, w (BH, T, dk), v (BH, T, dv), u (BH, dk) -> out (BH, T, dv) and the
// final state sfin (BH, dk, dv), f32; chunks of c tokens (T % c == 0,
// 1 <= c <= 64, 1 <= dk <= 64).  Returns the first CUDA error, if any.
extern "C" int wkv6_forward(const float* r, const float* k, const float* v,
                            const float* w, const float* u, float* out,
                            float* sfin, int BH, int T, int dk, int dv, int c,
                            void* stream) {
  if (BH < 1 || T < 1 || dk < 1 || dk > DKMAX || dv < 1 || c < 1 ||
      c > CMAX || T % c != 0 || (dv + DVT - 1) / DVT > 65535)
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (dv + DVT - 1) / DVT);
  wkv6_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, out, sfin, T, dk, dv, c);
  return (int)cudaGetLastError();
}
