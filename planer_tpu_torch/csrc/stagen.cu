// Hopper (sm_90a) kernel of the fused ResNet body stages (stagen).
//
// Replaces planer_tpu/ops/pallas/stagen.py:_stagen_kernel.  The TPU kernel
// runs a whole stage (basic or bottleneck blocks, a stride-2 entry, a 1x1
// projection) per grid step with every plane in VMEM.  A stage does not fit
// in one SM's 227 KB of shared memory (ResNet-50 layer1 is 800 KB of int8
// per image), so here the wrapper (ops/kernels/stagen.py) launches this
// fused conv-epilogue kernel once per conv of the stage, on int8 NHWC planes
// it owns.  Each launch is an implicit GEMM: M = output pixels, N = output
// channels, K = taps x input channels, s8 x s8 -> s32 on the tensor cores
// (mma.sync m16n8k32), then one of the reference's epilogues on the int32
// accumulators (EPI):
//   0  trunc-fold requant of a post-ReLU plane: clamp(acc*f + b, 0, 127.99)
//      truncated to int8 (b carries the folded +0.5);
//   1  the projection residual: clamp(floor(acc*f + b), -127, 127) to int8;
//   2  a block's final sum (acc*f + b) + res*sx with the int8 residual,
//      clipped and truncated to int8;
//   3  the same sum in the stage's last block: ReLU, bfloat16, written in
//      the public NCHW layout.
// The float arithmetic rounds each step in the reference's order
// (__fmul_rn/__fadd_rn, which nvcc does not contract into FMAs), so every
// plane equals the plain PyTorch version (stagen_plain) bit for bit.
//
// What bounds it on the H100: the convs of a stage are GEMM-shaped with
// K = 64-1152 and N = 64-512; at batch 64 a stage of ResNet-18/50 at 224
// is 53-132 GOP (2 per int8 MAC) against 26-116 MB of int8 input, weights
// and bf16 output, so it is operation-bound at the int8 tensor-core rate
// (1979 TOP/s: 27-67 us) with the whole stage on chip, and
// bytes-bound for the 1x1 convs on their own once every intermediate plane
// makes a round trip through device memory.  This first version moves each
// intermediate plane through device memory (L2 holds most of them at small
// batch) and feeds the tensor cores through mma.sync from a 3-stage cp.async
// ring; wgmma with TMA, and keeping the 1x1 -> 3x3 -> 1x1 chain on chip,
// are the later steps (measured times: PERF.md).
//
// Layouts: activations int8 NHWC with C a multiple of 64 (the wrapper pads
// with zero channels); weights int8 [O][tap][C] with O a multiple of 64;
// f, b float32 [O]; the residual int8 NHWC at the output's shape.  Every
// launch is on the caller's stream, allocates nothing, and the C entry point
// returns cudaGetLastError() for the wrapper to check.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // output pixels per block
constexpr int BN = 64;             // output channels per block
constexpr int BK = 64;             // K bytes per pipeline stage
constexpr int THREADS = 128;       // 4 warps, each 32 pixels x 64 channels
constexpr int LDS = BK + 16;       // 80-byte smem rows: conflict-free fragments
constexpr int A_BYTES = BM * LDS;  // 10240
constexpr int B_BYTES = BN * LDS;  // 5120
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int NSTAGE = 3;
static_assert(NSTAGE * STAGE_BYTES <= 48 * 1024, "static shared memory");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;     // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t trunc_i8(float v) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(v, 0.f), 127.99f)));
}

template <int KS, int STRIDE, int EPI>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ fs, const float* __restrict__ bs,
            const int8_t* __restrict__ res, float sx, void* __restrict__ out,
            int n, int H, int Cin, int Ho, int Cout) {
  __shared__ __align__(16) int8_t smem[NSTAGE * STAGE_BYTES];
  constexpr int PAD = KS / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int P = Ho * Ho;
  const int M = n * P;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cchunks = Cin / BK;
  const int ksteps = KS * KS * cchunks;
  const size_t K = (size_t)KS * KS * Cin;

  // this thread's four A rows (output pixels) and 16-byte column
  const int q = tid & 3;
  int a_img[4], a_iy[4], a_ix[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 2) + 32 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_img[i] = mm / P;
    const int p = mm % P;
    a_iy[i] = (p / Ho) * STRIDE - PAD;
    a_ix[i] = (p % Ho) * STRIDE - PAD;
  }

  auto load = [&](int s, int slot) {
    int8_t* As = smem + slot * STAGE_BYTES;
    int8_t* Bs = As + A_BYTES;
    const int tap = s / cchunks, cc = s % cchunks;
    const int dy = tap / KS, dx = tap % KS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
      const bool ok = a_ok[i] && iy >= 0 && iy < H && ix >= 0 && ix < H;
      const int8_t* src = ok ? x + (((size_t)a_img[i] * H + iy) * H + ix) * Cin + cc * BK + q * 16 : x;
      cp_async16(As + ((tid >> 2) + 32 * i) * LDS + q * 16, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 32 * i;
      cp_async16(Bs + r * LDS + q * 16, w + (size_t)(n0 + r) * K + (size_t)s * BK + q * 16, true);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < ksteps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < ksteps; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    const int nxt = s + NSTAGE - 1;
    if (nxt < ksteps) load(nxt, nxt % NSTAGE);
    cp_async_commit();
    const int8_t* As = smem + (s % NSTAGE) * STAGE_BYTES;
    const int8_t* Bs = As + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = As + (warp * 32 + mi * 16 + g) * LDS + kk + t4 * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* p = Bs + (ni * 8 + g) * LDS + kk + t4 * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator e of an m16n8 tile sits at row g + 8*(e/2),
  // column 2*t4 + e%2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 32 + mi * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int o = n0 + ni * 8 + 2 * t4;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), fs[o + e]), bs[o + e]);
        if (EPI == 0 || EPI == 1 || EPI == 2) {
          int8_t r8[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (EPI == 0) {
              r8[e] = trunc_i8(v[e]);
            } else if (EPI == 1) {
              r8[e] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(floorf(v[e]), -127.f), 127.f)));
            } else {
              const float r = __int2float_rn(res[(size_t)m * Cout + o + e]);
              r8[e] = trunc_i8(__fadd_rn(v[e], __fmul_rn(r, sx)));
            }
          }
          const uint16_t pair = static_cast<uint16_t>(static_cast<uint8_t>(r8[0])) |
                                static_cast<uint16_t>(static_cast<uint8_t>(r8[1])) << 8;
          *reinterpret_cast<uint16_t*>(reinterpret_cast<int8_t*>(out) + (size_t)m * Cout + o) = pair;
        } else {
          const int img = m / P, p = m % P;
          __nv_bfloat16* o16 = reinterpret_cast<__nv_bfloat16*>(out);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float r = __int2float_rn(res[(size_t)m * Cout + o + e]);
            const float y = __fadd_rn(v[e], __fmul_rn(r, sx));
            o16[((size_t)img * Cout + o + e) * P + p] = __float2bfloat16_rn(fmaxf(y, 0.f));
          }
        }
      }
    }
  }
}

template <int KS, int STRIDE>
int launch_epi(int epi, dim3 grid, cudaStream_t s, const int8_t* x, const int8_t* w,
               const float* f, const float* b, const int8_t* res, float sx, void* out,
               int n, int h, int cin, int ho, int cout) {
  switch (epi) {
    case 0: conv_kernel<KS, STRIDE, 0><<<grid, THREADS, 0, s>>>(x, w, f, b, res, sx, out, n, h, cin, ho, cout); break;
    case 1: conv_kernel<KS, STRIDE, 1><<<grid, THREADS, 0, s>>>(x, w, f, b, res, sx, out, n, h, cin, ho, cout); break;
    case 2: conv_kernel<KS, STRIDE, 2><<<grid, THREADS, 0, s>>>(x, w, f, b, res, sx, out, n, h, cin, ho, cout); break;
    case 3: conv_kernel<KS, STRIDE, 3><<<grid, THREADS, 0, s>>>(x, w, f, b, res, sx, out, n, h, cin, ho, cout); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One conv of a stage: x (n, h, h, cin) int8 NHWC -> (n, ho, ho, cout) int8
// NHWC (epi 0-2) or (n, cout, ho, ho) bf16 NCHW (epi 3).  cin and cout are
// multiples of 64; ks is 1 or 3 (pad ks/2), stride 1 or 2.
extern "C" int stagen_conv(const void* x, const void* w, const void* f, const void* b,
                           const void* res, float sx, void* out, int n, int h, int cin,
                           int cout, int ks, int stride, int epi, void* stream) {
  if (cin % BK || cout % BN || n <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if ((epi == 2 || epi == 3) && res == nullptr) return (int)cudaErrorInvalidValue;
  const int ho = (h + 2 * (ks / 2) - ks) / stride + 1;
  const long long m = (long long)n * ho * ho;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)(cout / BN));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xi = reinterpret_cast<const int8_t*>(x);
  const int8_t* wi = reinterpret_cast<const int8_t*>(w);
  const float* fi = reinterpret_cast<const float*>(f);
  const float* bi = reinterpret_cast<const float*>(b);
  const int8_t* ri = reinterpret_cast<const int8_t*>(res);
  if (ks == 1 && stride == 1) return launch_epi<1, 1>(epi, grid, s, xi, wi, fi, bi, ri, sx, out, n, h, cin, ho, cout);
  if (ks == 1 && stride == 2) return launch_epi<1, 2>(epi, grid, s, xi, wi, fi, bi, ri, sx, out, n, h, cin, ho, cout);
  if (ks == 3 && stride == 1) return launch_epi<3, 1>(epi, grid, s, xi, wi, fi, bi, ri, sx, out, n, h, cin, ho, cout);
  if (ks == 3 && stride == 2) return launch_epi<3, 2>(epi, grid, s, xi, wi, fi, bi, ri, sx, out, n, h, cin, ho, cout);
  return (int)cudaErrorInvalidValue;
}
