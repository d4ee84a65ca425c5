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
// the 32 x TN accumulator in registers; in the fused layer the (B, K, N)
// aggregate never reaches device memory, which is the point of the TPU
// kernel.  The TPU's mp_aggregate pads embed and adj to tile multiples in
// device memory first; here the ragged edges (k >= K, l >= Nl, n >= N) are
// zero-filled by the copies, so nothing is padded.
//
// The sum order.  Every output is one f32 accumulator, updated with one
// fmaf per l in ascending l, and the theta4 product one fmaf chain in
// ascending j.  The padded-sparse and CSR kernels (s2v_rows.cuh) walk their
// neighbours in ascending id with the same FMA and the same epilogue, so
// the three representations give the same bits; that is why the l axis is
// never split, summed as a tree or on the tensor cores (TF32).  Zero-filled
// edges add fmaf(e, 0, acc) == acc.
//
// What bounds it: at f32 both kernels read B*Nl*N*4 bytes of adj and do
// 2*B*K*Nl*N FLOPs, 16 FLOP/byte at K=32, against the H100's balance of 20
// for f32 on CUDA cores (67 TFLOP/s over 3.35 TB/s), so the kernel must
// keep the FMA pipe and HBM busy at once.  The design, for each limit:
//  - Shared memory to registers.  On this card a float4 shared-memory load
//    costs four 128-byte wavefronts whether or not lanes share addresses
//    (the times of this kernel's earlier designs fit that and not a
//    broadcast model), and an SM moves one wavefront, 32 floats, a clock
//    against 128 FMAs.  A thread with a KT x NT register tile loads KT + NT
//    floats per contraction row for KT*NT FMAs, so the FMA pipe waits on
//    shared memory below 4 FMAs per float.  The tile is 8 x 4 (2.67; the
//    first design's 8 x 2 gave 1.6): rows g + 4i of the columns 4h..4h+3
//    of the warp's 32, on a 4 (k) x 8 (n) lane grid, so the 8 lanes of a
//    quarter-warp read 128 contiguous bytes of adj in one float4 load and
//    one embed address.  8 x 8 (4 per float) needed ~240 registers and ran
//    slower, with one warp per scheduler.  At TN = 32 the tile is 4 x 4
//    (2 per float) so that a block has two compute warps: a block of one
//    compute warp and the producer put every compute warp on the same two
//    schedulers and ran slower still.  Embed is staged k-major with rows of
//    TL + 4 floats, which spreads the row groups over the banks.
//  - Bytes in flight.  One producer warp keeps STAGES = 4 (adj, embed) tile
//    pairs in flight with TMA tensor copies (cp.async.bulk.tensor), which
//    spend no compute registers or instructions; each stage has a full
//    mbarrier (the copies' bytes) and an empty one (the compute warps),
//    so there is no block-wide barrier in the loop.  At the serving shape
//    that is up to ~120 KB of tiles per SM, at paper scale ~60 KB of adj.
//    Ragged sizes (N or Nl not a multiple of 4, or an unaligned pointer,
//    which TMA does not take) use 4-byte cp.async copies with zero fill,
//    issued by the same warp and completing on the same barrier.
//  - Balance.  The tile width TN (32, 64 or 128 columns) is chosen per
//    launch by the wrapper (s2v_fused.py::dense_tile_columns) so that the
//    blocks spread evenly over the SMs: one graph of 20480 nodes makes 640
//    blocks of 32 columns (4.85 a SM, the busiest 5) where 64 columns gave
//    320 (the busiest 3 for 2.42).  Narrow tiles re-read embed from L2:
//    its traffic is K/TN of adj's.
// K < 32 is padded to 32 rows, so it costs the time of K = 32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KP = 32;          // embedding rows computed (K <= 32, zero-filled)
constexpr int TL = 32;          // contraction rows per stage
constexpr int ELD = TL + 4;     // a staged embed row: TL values + 4 of spread
constexpr int STAGES = 4;

// A block of TN columns: its compute warps' lanes form a KG (k) x NG (n)
// grid and each thread owns a KT x 4 register tile, rows g + KG*i of the
// columns 4h..4h+3 of its warp's WN.
template <int TN>
struct Tile {
  // 8 x 4, except at TN = 32, where 4 x 4 gives a block two compute warps
  // (the header says why)
  static constexpr int KT = TN == 32 ? 4 : 8;  // rows of a thread's tile
  static constexpr int KG = KP / KT;           // k-groups of a warp's lanes
  static constexpr int NG = 32 / KG;           // n-groups
  static constexpr int WN = NG * 4;            // columns a warp owns
  static constexpr int WARPS = TN / WN;        // compute warps
  static constexpr int THREADS = 32 * WARPS;   // they alone
  static constexpr int BLOCK = THREADS + 32;   // and the producer warp
  static constexpr int A_FLOATS = TL * TN;                // adj tile, [l][n]
  static constexpr int E_FLOATS = KP * ELD;               // embed tile, [k][l]
  static constexpr int STAGE_FLOATS = A_FLOATS + E_FLOATS;
  static constexpr unsigned TX_BYTES = 4u * STAGE_FLOATS;  // one stage's copies
  static constexpr int MIN_BLOCKS = TN == 128 ? 2 : TN == 64 ? 4 : 5;
  static_assert(WARPS >= 1 && TN % WN == 0, "a tile is whole warps wide");
  static_assert(A_FLOATS % 32 == 0 && E_FLOATS % 32 == 0,
                "stage buffers stay 128-byte aligned");
};

// Bytes of dynamic shared memory: the stages, theta4 (fused), the full and
// empty barriers, and 128 bytes to align the base for TMA.
template <int TN, bool FUSED>
constexpr size_t smem_bytes() {
  return 4 * (size_t)(STAGES * Tile<TN>::STAGE_FLOATS +
                      (FUSED ? KP * (KP + 1) : 0)) +
         16 * STAGES + 128;
}

template <bool BF16>
__device__ __forceinline__ float round_cd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One 3-D TMA tile copy into shared memory, completing on `bar`; elements
// outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A 4-byte asynchronous copy; src_bytes = 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// `bar` receives one arrival when this thread's earlier cp.async copies
// have landed (.noinc: the arrival counts against the barrier's count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// A barrier of the compute warps alone (named barrier 1: the producer warp
// has left).
__device__ __forceinline__ void block_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// FUSED: the layer (theta4, base, ReLU epilogue); otherwise the aggregate
// alone (theta4 and base unused).  tma: the stages are filled by the two
// tensor maps; otherwise by 4-byte copies from embed and adj.  vec: N % 4
// == 0 and out (and base) 16-byte aligned, so results go out as float4.
template <int TN, bool BF16, bool FUSED>
__global__ void __launch_bounds__(Tile<TN>::BLOCK, Tile<TN>::MIN_BLOCKS)
fused_dense_kernel(const __grid_constant__ CUtensorMap adj_map,
                   const __grid_constant__ CUtensorMap emb_map,
                   const float* __restrict__ theta4,
                   const float* __restrict__ embed,
                   const float* __restrict__ adj,
                   const float* __restrict__ base,
                   float* __restrict__ out, int K, int Nl, int N, bool tma,
                   bool vec) {
  using T = Tile<TN>;
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* t4_s = smem + STAGES * T::STAGE_FLOATS;    // [KP][KP + 1]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      t4_s + (FUSED ? KP * (KP + 1) : 0));
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tiles = (Nl + TL - 1) / TL;

  constexpr int KT = T::KT, KG = T::KG, NG = T::NG;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);
      mbar_init(&empty[s], T::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (FUSED) {
    for (int i = tid; i < KP * KP; i += T::BLOCK) {
      const int r = i / KP, q = i % KP;
      t4_s[r * (KP + 1) + q] =
          (r < K && q < K) ? round_cd<BF16>(theta4[r * K + q]) : 0.f;
    }
  }
  __syncthreads();

  if (warp == T::WARPS) {
    // The producer warp: tile t goes to buffer t % STAGES once every
    // compute warp has released the buffer's previous tile, by two TMA
    // copies from lane 0, or by 4-byte copies from all its lanes.
    if (tma && lane != 0) return;
    const float* adj_b = adj + (size_t)b * Nl * N;
    const float* emb_b = embed + (size_t)b * K * Nl;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) + 1) & 1);
      float* a_st = smem + s * T::STAGE_FLOATS;
      float* e_st = a_st + T::A_FLOATS;
      const int l0 = t * TL;
      if (tma) {
        mbar_expect_tx(&full[s], T::TX_BYTES);
        tma_load_3d(a_st, &adj_map, &full[s], n0, l0, b);
        tma_load_3d(e_st, &emb_map, &full[s], l0, 0, b);
      } else {
        for (int i = lane; i < T::A_FLOATS; i += 32) {
          const int l = l0 + i / TN, n = n0 + i % TN;
          const bool ok = l < Nl && n < N;
          cp_async4(&a_st[i], ok ? adj_b + (size_t)l * N + n : adj_b, ok);
        }
        for (int i = lane; i < KP * TL; i += 32) {
          const int k = i / TL, l = l0 + i % TL;
          const bool ok = k < K && l < Nl;
          cp_async4(&e_st[k * ELD + i % TL],
                    ok ? emb_b + (size_t)k * Nl + l : emb_b, ok);
        }
        cp_async_arrive(&full[s]);
      }
    }
    return;
  }

  // Lane (g, h) owns rows g + KG*i and the columns col..col+3 of the
  // tile: at 8 x 4 the 8 lanes of a quarter-warp read 128 contiguous bytes
  // of adj in one float4 load.
  const int g = lane / NG, h = lane % NG;
  const int col = warp * T::WN + h * 4;
  float acc[KT][4];
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    float* a_st = smem + s * T::STAGE_FLOATS;
    float* e_st = a_st + T::A_FLOATS;
    if constexpr (BF16) {
      // Round the stage in place, once: every thread a share.
      for (int i = tid; i < T::A_FLOATS / 4; i += T::THREADS) {
        float4* p = reinterpret_cast<float4*>(a_st) + i;
        float4 v = *p;
        *p = make_float4(round_cd<true>(v.x), round_cd<true>(v.y),
                         round_cd<true>(v.z), round_cd<true>(v.w));
      }
      for (int i = tid; i < KP * TL / 4; i += T::THREADS) {
        float4* p = reinterpret_cast<float4*>(e_st + (i / (TL / 4)) * ELD) +
                    i % (TL / 4);
        float4 v = *p;
        *p = make_float4(round_cd<true>(v.x), round_cd<true>(v.y),
                         round_cd<true>(v.z), round_cd<true>(v.w));
      }
      // the buffer is next written by the async proxy (TMA)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      block_sync(T::THREADS);
    }
    const float* a_t = a_st + col;
    const float* e_t = e_st + g * ELD;
#pragma unroll
    for (int l = 0; l < TL; l += 4) {
      float4 e[KT];
#pragma unroll
      for (int i = 0; i < KT; ++i) e[i] = ld4(e_t + i * KG * ELD + l);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a = ld4(a_t + (l + u) * TN);
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const float ev = comp(e[i], u);
          acc[i][0] = fmaf(ev, a.x, acc[i][0]);
          acc[i][1] = fmaf(ev, a.y, acc[i][1]);
          acc[i][2] = fmaf(ev, a.z, acc[i][2]);
          acc[i][3] = fmaf(ev, a.w, acc[i][3]);
        }
      }
    }
    __syncwarp();                       // the warp's reads of stage s are done
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int n = n0 + col;
  if constexpr (!FUSED) {   // the f32 aggregate, unrounded
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int k = g + KG * i;
      if (k >= K) continue;
      float* o = out + ((size_t)b * K + k) * N + n;
      if (vec) {
        if (n < N)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < N) o[c] = acc[i][c];
      }
    }
  } else {
    // Epilogue: the aggregate, rounded once, goes through shared memory (the
    // first stage's adj buffer, free once every warp has left the loop) so
    // that each thread sees all KP rows of its columns for theta4.
    float* agg_s = smem;                  // [KP][TN]
    block_sync(T::THREADS);
#pragma unroll
    for (int i = 0; i < KT; ++i)
      *reinterpret_cast<float4*>(&agg_s[(g + KG * i) * TN + col]) =
          make_float4(round_cd<BF16>(acc[i][0]), round_cd<BF16>(acc[i][1]),
                      round_cd<BF16>(acc[i][2]), round_cd<BF16>(acc[i][3]));
    block_sync(T::THREADS);

    // e3 = theta4 @ agg, one fmaf chain over ascending q for each output
    float e3[KT][4];
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) e3[i][c] = 0.f;
#pragma unroll 2
    for (int q = 0; q < KP; ++q) {
      const float4 v = ld4(&agg_s[q * TN + col]);
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const float t = t4_s[(g + KG * i) * (KP + 1) + q];
        e3[i][0] = fmaf(t, v.x, e3[i][0]);
        e3[i][1] = fmaf(t, v.y, e3[i][1]);
        e3[i][2] = fmaf(t, v.z, e3[i][2]);
        e3[i][3] = fmaf(t, v.w, e3[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int k = g + KG * i;
      if (k >= K) continue;
      const size_t row = ((size_t)b * K + k) * N + n;
      if (vec) {
        if (n < N) {
          const float4 bv = ld4(base + row);
          *reinterpret_cast<float4*>(out + row) =
              make_float4(fmaxf(bv.x + e3[i][0], 0.f),
                          fmaxf(bv.y + e3[i][1], 0.f),
                          fmaxf(bv.z + e3[i][2], 0.f),
                          fmaxf(bv.w + e3[i][3], 0.f));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < N) out[row + c] = fmaxf(base[row + c] + e3[i][c], 0.f);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
#endif
      p = nullptr;
    return p != nullptr && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous (d2, d1, d0) f32 array, copied in boxes of
// (1, box1, box0); elements outside the array are read as zeros.
int tensor_map(CUtensorMap* map, const float* ptr, int d0, int d1, int d2,
               int box0, int box1) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {4ull * d0, 4ull * d0 * d1};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int TN, bool FUSED>
int launch_tn(const float* theta4, const float* embed, const float* adj,
              const float* base, float* out, int B, int K, int Nl, int N,
              bool bf16, cudaStream_t s) {
  // TMA takes 16-byte aligned rows: N and Nl multiples of 4
  const bool tma = N % 4 == 0 && Nl % 4 == 0 && aligned16(adj) &&
                   aligned16(embed);
  const bool vec = N % 4 == 0 && aligned16(out) && (!FUSED || aligned16(base));
  CUtensorMap adj_map = {}, emb_map = {};
  if (tma) {
    int err = tensor_map(&adj_map, adj, N, Nl, B, TN, TL);
    if (err == 0) err = tensor_map(&emb_map, embed, Nl, K, B, ELD, KP);
    if (err != 0) return err;
  }
  auto* kernel = bf16 ? &fused_dense_kernel<TN, true, FUSED>
                      : &fused_dense_kernel<TN, false, FUSED>;
  const size_t smem = smem_bytes<TN, FUSED>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TN - 1) / TN, B);
  kernel<<<grid, Tile<TN>::BLOCK, smem, s>>>(adj_map, emb_map, theta4, embed,
                                               adj, base, out, K, Nl, N, tma,
                                               vec);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int launch_k(const float* theta4, const float* embed, const float* adj,
             const float* base, float* out, int B, int K, int Nl, int N,
             int bf16, int tile_n, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > KP || Nl < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_n) {
    case 32:
      return launch_tn<32, FUSED>(theta4, embed, adj, base, out, B, K, Nl, N,
                                  bf16 != 0, s);
    case 64:
      return launch_tn<64, FUSED>(theta4, embed, adj, base, out, B, K, Nl, N,
                                  bf16 != 0, s);
    case 128:
      return launch_tn<128, FUSED>(theta4, embed, adj, base, out, B, K, Nl, N,
                                   bf16 != 0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel 1.  Launches the fused layer on `stream` in tiles of tile_n (32, 64
// or 128) columns.  All tensors are f32 and contiguous: theta4 (K,K), embed
// (B,K,Nl), adj (B,Nl,N), base and out (B,K,N).  bf16 != 0 selects bf16
// operand rounding.  Returns a CUDA error code (0 on success).
extern "C" int s2v_fused_layer(const float* theta4, const float* embed,
                               const float* adj, const float* base, float* out,
                               int B, int K, int Nl, int N, int bf16,
                               int tile_n, void* stream) {
  return launch_k<true>(theta4, embed, adj, base, out, B, K, Nl, N, bf16,
                        tile_n, stream);
}

// Kernel 2.  Launches the aggregate on `stream` in tiles of tile_n columns:
// embed (B,K,Nl), adj (B,Nl,N), out (B,K,N), all f32 and contiguous.
// bf16 != 0 rounds the operands to bf16; the sum and the output stay f32.
// Returns a CUDA error code (0 on success).
extern "C" int s2v_mp_aggregate(const float* embed, const float* adj,
                                float* out, int B, int K, int Nl, int N,
                                int bf16, int tile_n, void* stream) {
  return launch_k<false>(nullptr, embed, adj, nullptr, out, B, K, Nl, N, bf16,
                         tile_n, stream);
}
