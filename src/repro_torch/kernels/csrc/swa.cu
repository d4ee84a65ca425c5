// Sliding-window causal attention for Hopper (sm_90a), f32, flash style:
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
// (head, 64-query tile) and loops over exactly the key tiles that overlap
// [q0 - window + 1, q0 + 63]; nothing is clamped, aliased or dropped.
//
// What bounds it: operations.  At gemma3-4b's local layers (BH = 16,
// T = 8192, d = 256, window 1024) the 1.26e8 visible (query, key) pairs cost
// 4 d FLOPs each, 1.29e11 in all (1.92 ms at 67 TFLOP/s on CUDA cores),
// against 537 MB of traffic (0.160 ms).  The design reads q, k and v once per
// (query tile, key tile) pair from L2/HBM through 16-byte cp.async copies
// into shared memory: the value tile's copy is in flight while the scores
// are computed, and the next key tile's while the softmax and the value
// product run.  A thread owns a 4 x 4 tile of the 64 x 64 scores (its key
// columns strided by 16, so the float4 reads of four key rows fall in
// distinct banks) and a 4 x (4 per 64 columns) tile of the output, so each
// float4 load feeds 4-16 FMAs.  head_dim 256 is what makes it tight: the
// q, k and v tiles (64 rows of d + 4 floats each) and the probability tile
// take 217,088 bytes of shared memory at d = 256, above the 48 KB default,
// so the launch first raises the block's dynamic shared-memory limit
// (cudaFuncSetAttribute, error checked) and runs one block per SM; the
// (64, 256) f32 accumulator is 64 registers a thread at 256 threads.
// Tensor cores (TF32/bf16 wgmma), TMA and two consumer warpgroups are left
// for the PR that makes it fast.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // queries per block
constexpr int BKV = 64;             // keys per tile
constexpr int THREADS = 256;        // 16 x 16 threads
constexpr int LDP = BQ + 4;         // row stride of the probability tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N_PENDING));
}

// Rows row0.. row0+63 of one head's (T, d) array into a tile of stride
// d + 4; rows at or past T are zero-filled (their address is clamped).
__device__ __forceinline__ void load_tile(float* tile, const float* head,
                                          int row0, int T, int d) {
  const int per_row = d / 4;
  for (int idx = threadIdx.x; idx < BKV * per_row; idx += THREADS) {
    const int row = idx / per_row, c4 = idx % per_row;
    const bool ok = row0 + row < T;
    cp_async16(tile + row * (d + 4) + 4 * c4,
               head + (size_t)(ok ? row0 + row : 0) * d + 4 * c4, ok);
  }
}

// d <= 64 * NG; thread column groups beyond d are skipped.
template <int NG>
__global__ void __launch_bounds__(THREADS, 1)
swa_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int T, int d,
           int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BKV * ld;
  float* Ps = Vs + BKV * ld;           // probabilities, stored [s][t]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t head = (size_t)blockIdx.y * T * d;
  const int q0 = blockIdx.x * BQ;
  const int lo = max(0, q0 - window + 1);
  const int hi = min(T - 1, q0 + BQ - 1);
  const int kt_lo = lo / BKV, kt_hi = hi / BKV;

  float o[4][NG][4];
  float m_run[4], l_run[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[a][g][e] = 0.f;
  }

  load_tile(Qs, q + head, q0, T, d);
  load_tile(Ks, k + head, kt_lo * BKV, T, d);
  cp_async_commit();
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    load_tile(Vs, v + head, k0, T, d);
    cp_async_commit();
    cp_async_wait<1>();                  // q and this key tile have landed
    __syncthreads();

    // scores: rows t = ty*4 + a, key columns s = tx + 16*b
    float sc[4][4] = {};
    for (int c = 0; c < d; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + a) * ld + c);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        kv[b] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * b) * ld + c);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          sc[a][b] = fmaf(qv[a].x, kv[b].x, sc[a][b]);
          sc[a][b] = fmaf(qv[a].y, kv[b].y, sc[a][b]);
          sc[a][b] = fmaf(qv[a].z, kv[b].z, sc[a][b]);
          sc[a][b] = fmaf(qv[a].w, kv[b].w, sc[a][b]);
        }
    }
    __syncthreads();                     // every thread is done with Ks
    if (kt < kt_hi) load_tile(Ks, k + head, k0 + BKV, T, d);
    cp_async_commit();                   // (an empty group on the last tile)

    // online softmax over this tile; the 16 threads of a row group (one
    // half-warp) hold its 64 columns
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty * 4 + a;
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = k0 + tx + 16 * b;
        const bool seen = i < T && j <= i && j > i - window;
        sc[a][b] = seen ? sc[a][b] * scale : -INFINITY;
        mx = fmaxf(mx, sc[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m_run[a], mx);
      // a row with nothing seen yet keeps p = 0 and alpha = 0 (exp(-inf))
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run[a] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sc[a][b] = expf(sc[a][b] - m_use);
        sum += sc[a][b];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l_run[a] = l_run[a] * alpha + sum;
      m_run[a] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[a][g][e] *= alpha;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * b) * LDP + ty * 4) =
          make_float4(sc[0][b], sc[1][b], sc[2][b], sc[3][b]);
    cp_async_wait<1>();                  // this value tile has landed
    __syncthreads();

    // o += p v: rows t = ty*4 + a, columns tx*4 + 64*g + e
    for (int s = 0; s < BKV; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + s * LDP + ty * 4);
      const float pm[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = tx * 4 + 64 * g;
        if (col < d) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + s * ld + col);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            o[a][g][0] = fmaf(pm[a], vv.x, o[a][g][0]);
            o[a][g][1] = fmaf(pm[a], vv.y, o[a][g][1]);
            o[a][g][2] = fmaf(pm[a], vv.z, o[a][g][2]);
            o[a][g][3] = fmaf(pm[a], vv.w, o[a][g][3]);
          }
        }
      }
    }
    __syncthreads();                     // Vs and Ps are free again
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty * 4 + a;
    if (i >= T) break;
    const float inv = 1.f / fmaxf(l_run[a], 1e-20f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = tx * 4 + 64 * g;
      if (col < d)
        *reinterpret_cast<float4*>(out + head + (size_t)i * d + col) =
            make_float4(o[a][g][0] * inv, o[a][g][1] * inv, o[a][g][2] * inv,
                        o[a][g][3] * inv);
    }
  }
}

template <int NG>
int launch(const float* q, const float* k, const float* v, float* out,
           int BH, int T, int d, int window, float scale,
           cudaStream_t stream) {
  const int bytes = (int)sizeof(float) * ((BQ + 2 * BKV) * (d + 4) + BKV * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, BH);
  swa_kernel<NG><<<grid, THREADS, bytes, stream>>>(q, k, v, out, T, d,
                                                   window, scale);
  return (int)cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1: return launch<1>(q, k, v, out, BH, T, d, window, scale, s);
    case 2: return launch<2>(q, k, v, out, BH, T, d, window, scale, s);
    case 3: return launch<3>(q, k, v, out, BH, T, d, window, scale, s);
    default: return launch<4>(q, k, v, out, BH, T, d, window, scale, s);
  }
}
