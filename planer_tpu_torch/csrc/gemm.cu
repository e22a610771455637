// Hopper (sm_90a) kernel of the weight-only int8 / fp8 GEMM (dense_q).
//
// dense_q replaces planer_tpu/ops/pallas/gemm.py:_dense_q_kernel together with
// the cast and bias of gemm.py:dense_q: out = cast(bf16(x) . bf16(q)^T * scale)
// + bias, with x (M, Kd) in f32 or bf16, q (N, Kd) int8 or float8_e4m3fn (one
// byte a weight either way), scale (N) f32 and the output and bias in x's
// dtype.  Both weight types are exact in bf16, as the reference's cast at
// gemm.py:59 assumes: e4m3 bytes decode through cvt.rn.f16x2.e4m3x2 (exact:
// every e4m3 value is an f16, f32 and bf16 value).  The tensor cores run bf16,
// never fp8: an e4m3 MMA would need x in fp8, which the reference does not
// round it to.  The products of bf16 values are exact in f32 and summed in
// f32 by the tensor cores (mma.sync m16n8k16 bf16 -> f32); the epilogue rounds
// acc * scale once (__fmul_rn), casts to x's dtype and adds the bias in that
// dtype, rounding once more, as the reference's cast-then-add does.  The sum
// order differs from the reference's and from torch.matmul's, so results
// agree within the f32 rounding of the sums, not bit for bit.
//
// What bounds it on the H100: at the shapes it runs (ResNet-50's 1x1 convs,
// Kd and N of 128-2048) it does 2*Kd flops per byte of x read, under the
// ~295 flops per byte where bf16 tensor cores would become the limit, so it
// is bound by device memory: x read once per 128-column tile of the output,
// the weights once per 128-row tile, the output written once.  This first
// version is a plain tiled GEMM: 128x128x32 block tiles, 8 warps of 64x32,
// a 3-stage cp.async ring of the raw x and weight-byte tiles, converted to
// bf16 in shared memory (x rounded with __float2bfloat16_rn, weights exact)
// and fed to the tensor cores through ldmatrix.  Blocks that share rows of x
// run next to each other, so x comes from L2 for all but the first column
// tile.  The M tail is predicated (cp.async zero-fill, guarded stores); Kd
// and N are multiples of 128 by the wrapper's gate.  wgmma with TMA, and
// reading the NCHW activations in place of the route's transposed copy, are
// later work.
//
// The launch is on the caller's stream, allocates nothing, and the C entry
// point returns cudaGetLastError() for the wrapper to check.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;       // bf16 tile row stride: 80 bytes, no ldmatrix bank conflicts
enum WType { W_INT8 = 0, W_E4M3 = 1 };   // the C entry point's wdtype codes

template <typename TA>
struct Smem {
  static constexpr int A_RAW = BM * BK * (int)sizeof(TA);   // one stage of x
  static constexpr int B_RAW = BN * BK;                      // one stage of q (bytes)
  static constexpr int STAGE = A_RAW + B_RAW;
  static constexpr int TILES = STAGES * STAGE;               // bf16 tiles after the ring
  static constexpr int BYTES = TILES + 2 * BM * LDS * 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two e4m3 bytes (byte 0 -> the low half) -> two bf16, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(__nv_fp8x2_storage_t v) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(v, __NV_E4M3)));
  return pack_bf16(f.x, f.y);
}

// raw stage <- x rows [m0, m0+BM) x cols [k0, k0+BK), q rows [n0, n0+BN) x the same cols
template <typename TA>
__device__ __forceinline__ void load_stage(unsigned char* st, const TA* __restrict__ x,
                                           const uint8_t* __restrict__ q, int M, int Kd,
                                           int m0, int n0, int k0) {
  constexpr int A_CHUNKS_ROW = BK * (int)sizeof(TA) / 16;      // 8 (f32) or 4 (bf16)
  constexpr int A_CHUNKS = BM * A_CHUNKS_ROW;
  for (int i = threadIdx.x; i < A_CHUNKS; i += THREADS) {
    const int r = i / A_CHUNKS_ROW, c = i % A_CHUNKS_ROW;
    const int m = m0 + r;
    const bool ok = m < M;
    const TA* src = x + (size_t)(ok ? m : 0) * Kd + k0 + c * (16 / (int)sizeof(TA));
    cp_async16(st + (r * A_CHUNKS_ROW + c) * 16, src, ok);
  }
  unsigned char* bq = st + Smem<TA>::A_RAW;
  for (int i = threadIdx.x; i < BN * 2; i += THREADS) {            // 2 chunks of 16 bytes a row
    const int r = i >> 1, c = i & 1;
    cp_async16(bq + r * BK + c * 16, q + (size_t)(n0 + r) * Kd + k0 + c * 16, true);
  }
}

// raw stage -> bf16 tiles: each thread converts 16 elements of x and 16 of q
template <typename TA, int WT>
__device__ __forceinline__ void convert_stage(const unsigned char* st, __nv_bfloat16* As,
                                              __nv_bfloat16* Bs) {
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 16;
  uint32_t w[8];
  if constexpr (sizeof(TA) == 4) {
    const float4* src = reinterpret_cast<const float4*>(st) + (r * BK + c0) / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = src[j];
      w[2 * j] = pack_bf16(v.x, v.y);
      w[2 * j + 1] = pack_bf16(v.z, v.w);
    }
  } else {
    const uint4* src = reinterpret_cast<const uint4*>(st) + (r * BK + c0) / 8;
    const uint4 v0 = src[0], v1 = src[1];
    w[0] = v0.x; w[1] = v0.y; w[2] = v0.z; w[3] = v0.w;
    w[4] = v1.x; w[5] = v1.y; w[6] = v1.z; w[7] = v1.w;
  }
  uint4* dst = reinterpret_cast<uint4*>(As + r * LDS + c0);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);

  const uint4 qv = *reinterpret_cast<const uint4*>(st + Smem<TA>::A_RAW + r * BK + c0);
  if constexpr (WT == W_INT8) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&qv);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = pack_bf16((float)b[2 * j], (float)b[2 * j + 1]);  // exact
  } else {
    const __nv_fp8x2_storage_t* b = reinterpret_cast<const __nv_fp8x2_storage_t*>(&qv);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = e4m3x2_to_bf16x2(b[j]);
  }
  uint4* dq = reinterpret_cast<uint4*>(Bs + r * LDS + c0);
  dq[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dq[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename TA>
__device__ __forceinline__ TA out_cast(float v);
template <>
__device__ __forceinline__ float out_cast<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 out_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TA>
__device__ __forceinline__ void store2(TA* p, TA a, TA b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, __nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

template <typename TA, int WT>
__global__ void __launch_bounds__(THREADS, 2)
dense_q_kernel(const TA* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ scale, const TA* __restrict__ bias,
               TA* __restrict__ out, int M, int N, int Kd) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + Smem<TA>::TILES);
  __nv_bfloat16* Bs = As + BM * LDS;

  // n tiles fastest: the blocks that read the same rows of x run together
  const int ntiles = N / BN;
  const int n0 = (blockIdx.x % ntiles) * BN;
  const int m0 = (blockIdx.x / ntiles) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;   // 2 warps down M
  const int wn = (warp & 3) * 32;    // 4 warps across N

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = Kd / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage<TA>(smem + s * Smem<TA>::STAGE, x, q, M, Kd, m0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed for every thread; the last tile's readers are done
    convert_stage<TA, WT>(smem + (kt % STAGES) * Smem<TA>::STAGE, As, Bs);
    const int nk = kt + STAGES - 1;  // its ring slot was converted an iteration ago
    if (nk < KT)
      load_stage<TA>(smem + (nk % STAGES) * Smem<TA>::STAGE, x, q, M, Kd, m0, n0, nk * BK);
    cp_async_commit();
    __syncthreads();   // bf16 tiles ready
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], As + (wm + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int mat = lane >> 3;
        const int row = wn + j * 16 + (mat >> 1) * 8 + (lane & 7);
        ldmatrix_x4(b[j], Bs + row * LDS + kk + (mat & 1) * 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + (lane & 3) * 2;
    const float s0 = scale[n], s1 = scale[n + 1];
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = as_float(bias[n]);
      b1 = as_float(bias[n + 1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + (lane >> 2) + h * 8;
        if (m >= M) continue;
        TA y0 = out_cast<TA>(__fmul_rn(acc[i][j][2 * h], s0));
        TA y1 = out_cast<TA>(__fmul_rn(acc[i][j][2 * h + 1], s1));
        if (bias != nullptr) {
          y0 = out_cast<TA>(__fadd_rn(as_float(y0), b0));
          y1 = out_cast<TA>(__fadd_rn(as_float(y1), b1));
        }
        store2<TA>(out + (size_t)m * N + n, y0, y1);
      }
    }
  }
}

template <typename TA, int WT>
static int launch(const void* x, const void* q, const void* scale, const void* bias, void* out,
                  int M, int N, int Kd, cudaStream_t s) {
  if (M <= 0 || N % BN || Kd % BK) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dense_q_kernel<TA, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<TA>::BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((M + BM - 1) / BM) * (N / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dense_q_kernel<TA, WT><<<(unsigned)blocks, THREADS, Smem<TA>::BYTES, s>>>(
      reinterpret_cast<const TA*>(x), reinterpret_cast<const uint8_t*>(q),
      reinterpret_cast<const float*>(scale), reinterpret_cast<const TA*>(bias),
      reinterpret_cast<TA*>(out), M, N, Kd);
  return (int)cudaGetLastError();
}

template <typename TA>
static int launch_w(const void* x, const void* q, const void* scale, const void* bias, void* out,
                    int M, int N, int Kd, int wdtype, cudaStream_t s) {
  switch (wdtype) {
    case W_INT8:
      return launch<TA, W_INT8>(x, q, scale, bias, out, M, N, Kd, s);
    case W_E4M3:
      return launch<TA, W_E4M3>(x, q, scale, bias, out, M, N, Kd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// xdtype: 0 = float32, 1 = bfloat16 (x, bias and out); wdtype: 0 = int8, 1 = e4m3 (q)
extern "C" int dense_q(const void* x, const void* q, const void* scale, const void* bias,
                       void* out, int M, int N, int Kd, int xdtype, int wdtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (xdtype) {
    case 0:
      return launch_w<float>(x, q, scale, bias, out, M, N, Kd, wdtype, s);
    case 1:
      return launch_w<__nv_bfloat16>(x, q, scale, bias, out, M, N, Kd, wdtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
