// Hopper (sm_90a) kernels of the fused ResNet entry stage (stage64).
//
// stem_pool_requant replaces planer_tpu/ops/pallas/stage64.py:_stage_kernel
// in its stem-only forms: a 7x7/2 pad-3 s8 x s8 -> s32 conv of the quantized
// image, the 3x3/2 pad-1 maxpool taken on the raw int32 accumulators (the
// border is the -2^30 sentinel), then ONE requant of the pooled plane:
// int32 fixed point clamp((acc*m + B) >> s, 0, 127) (MODE 0, the main path),
// f32 acc*f + b -> ReLU -> bf16 (MODE 1) or f32 clipped and truncated to int8
// (MODE 2).
//
// basic_block replaces stage64.py:_block_kernel: one C=64 basic block on int8
// codes.  conv3x3 -> requant (ReLU folded into the clip) -> int8 mid plane
// kept in shared memory, never in device memory (halos recomputed at tile
// edges) -> conv3x3 + residual -> requant to int8 out, or, for the last block
// of a stage without out_scale, exact f32 acc*f2 + b2 + res*sx, ReLU, bf16.
// The int8 requants are the reference's REQUANT forms: int32 fixed point
// (fxp, the default) or, with TRUNC, f32 acc*f + b [+ res*sx] clipped to
// [0, 127.99] and truncated (stage64.py:627-629, :644-648).  The reference's
// one-call form (SPLIT = False: _stage_kernel with blocks) computes the same
// function as the trunc stem followed by the trunc blocks, so the wrapper
// runs it as that chain of launches.
//
// What bounds them on the H100: both do 0.24 (stem) and 0.46 (block) GOP per
// image of int8 MACs against 0.35-0.6 MB per image of device-memory traffic,
// so at the int8 tensor-core rate (1979 TOP/s) they would be compute-bound
// near the memory bound.  This first version uses __dp4a on the CUDA cores,
// not the tensor cores: it is bounded by dp4a issue, far above the bound
// (measured times: PERF.md).  The design keeps the device-memory traffic at
// the minimum - one read of the input, one write of the output, the stem's
// int32 accumulators and the block's mid plane live only in shared memory -
// so a later tensor-core (mma / wgmma) inner loop can replace the dp4a loop
// without changing the data flow.
//
// Every launch is on the caller's stream, allocates nothing, and the C entry
// points return cudaGetLastError() for the wrapper to check.  Layouts: all
// global tensors are NCHW; weights come pre-packed by the wrapper.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_SENTINEL (-(1 << 30))

// ---------------------------------------------------------------------------
// stem
// ---------------------------------------------------------------------------
// One block = a tile of ST_PR x ST_PC pooled outputs, all 64 channels.  It
// needs (2*ST_PR+1) x (2*ST_PC+1) stem-conv outputs (9 x 29 = 261), which
// 288 threads compute one pixel each (all 64 channels, 37 dp4a words of the
// 7x7x3 patch), into int32 shared memory; the pool and the requant then read
// them from there.
constexpr int ST_PR = 4;
constexpr int ST_PC = 14;
constexpr int ST_CR = 2 * ST_PR + 1;            // conv rows of a tile
constexpr int ST_CC = 2 * ST_PC + 1;            // conv cols of a tile
constexpr int ST_NPIX = ST_CR * ST_CC;          // 261
constexpr int ST_IR = 2 * (ST_CR - 1) + 7;      // 23 input rows
constexpr int ST_IC = 2 * (ST_CC - 1) + 7;      // 63 input cols
constexpr int ST_ICP = 64;                      // padded input row (bytes)
constexpr int ST_THREADS = 288;
constexpr int ST_KW = 37;                       // 148 bytes = 147 taps + 1
constexpr int ST_KWP = 40;                      // words per channel in smem
constexpr int ST_XS_BYTES = 3 * ST_IR * ST_ICP;         // 4416
constexpr int ST_WS_BYTES = 64 * ST_KWP * 4;            // 10240
constexpr int ST_ACC_BYTES = 64 * ST_NPIX * 4;          // 66816
constexpr int ST_SMEM = ST_XS_BYTES + ST_WS_BYTES + ST_ACC_BYTES;
static_assert(ST_XS_BYTES % 16 == 0, "weights must stay 16-byte aligned");
static_assert(ST_NPIX <= ST_THREADS, "one conv pixel per thread");

template <int MODE>
__global__ void __launch_bounds__(ST_THREADS)
stem_kernel(const int8_t* __restrict__ x, const int32_t* __restrict__ w148,
            const void* __restrict__ table, void* __restrict__ out,
            int H, int R, int tiles_r, int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  int32_t* ws = reinterpret_cast<int32_t*>(smem + ST_XS_BYTES);
  int32_t* accs = reinterpret_cast<int32_t*>(smem + ST_XS_BYTES + ST_WS_BYTES);

  const int tid = threadIdx.x;
  const int tiles = tiles_r * tiles_c;
  const int n = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int pr0 = (t / tiles_c) * ST_PR;
  const int pc0 = (t % tiles_c) * ST_PC;
  const int Hc = H / 2;                    // stem conv output side
  const int cr0 = 2 * pr0 - 1, cc0 = 2 * pc0 - 1;   // first conv row / col
  const int ir0 = 2 * cr0 - 3, ic0 = 2 * cc0 - 3;   // first input row / col
  const int8_t* xn = x + (size_t)n * 3 * H * H;

  for (int i = tid; i < 3 * ST_IR * ST_IC; i += ST_THREADS) {
    const int c = i / (ST_IR * ST_IC);
    const int rem = i % (ST_IR * ST_IC);
    const int r = rem / ST_IC, col = rem % ST_IC;
    const int iy = ir0 + r, ix = ic0 + col;
    int8_t v = 0;
    if (iy >= 0 && iy < H && ix >= 0 && ix < H) v = xn[((size_t)c * H + iy) * H + ix];
    xs[(c * ST_IR + r) * ST_ICP + col] = v;
  }
  for (int i = tid; i < 64 * ST_KWP; i += ST_THREADS) {
    const int o = i / ST_KWP, j = i % ST_KWP;
    ws[i] = j < ST_KW ? w148[o * ST_KW + j] : 0;
  }
  __syncthreads();

  if (tid < ST_NPIX) {
    const int lr = tid / ST_CC, lc = tid % ST_CC;
    const int cy = cr0 + lr, cx = cc0 + lc;
    if (cy >= 0 && cy < Hc && cx >= 0 && cx < Hc) {
      // the patch in the weights' flat (c, ky, kx) order, 4 taps per word
      int patch[ST_KW];
      const int8_t* base = xs + (2 * lr) * ST_ICP + 2 * lc;
#pragma unroll
      for (int j = 0; j < ST_KW; ++j) {
        uint32_t wv = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * j + e;
          if (k < 147) {
            const int c = k / 49, ky = (k / 7) % 7, kx = k % 7;
            wv |= (uint32_t)(uint8_t)base[(c * ST_IR + ky) * ST_ICP + kx] << (8 * e);
          }
        }
        patch[j] = (int)wv;
      }
      for (int o = 0; o < 64; ++o) {
        const int4* wr = reinterpret_cast<const int4*>(ws + o * ST_KWP);
        int acc = 0;
#pragma unroll
        for (int j4 = 0; j4 < ST_KWP / 4; ++j4) {
          const int4 w = wr[j4];
          if (4 * j4 + 0 < ST_KW) acc = __dp4a(patch[4 * j4 + 0], w.x, acc);
          if (4 * j4 + 1 < ST_KW) acc = __dp4a(patch[4 * j4 + 1], w.y, acc);
          if (4 * j4 + 2 < ST_KW) acc = __dp4a(patch[4 * j4 + 2], w.z, acc);
          if (4 * j4 + 3 < ST_KW) acc = __dp4a(patch[4 * j4 + 3], w.w, acc);
        }
        accs[o * ST_NPIX + tid] = acc;
      }
    } else {
      for (int o = 0; o < 64; ++o) accs[o * ST_NPIX + tid] = NEG_SENTINEL;
    }
  }
  __syncthreads();

  for (int i = tid; i < 64 * ST_PR * ST_PC; i += ST_THREADS) {
    const int o = i / (ST_PR * ST_PC);
    const int rem = i % (ST_PR * ST_PC);
    const int pr = rem / ST_PC, pc = rem % ST_PC;
    const int gy = pr0 + pr, gx = pc0 + pc;
    if (gy >= R || gx >= R) continue;
    const int32_t* a = accs + o * ST_NPIX + (2 * pr) * ST_CC + 2 * pc;
    int m = NEG_SENTINEL;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = max(m, a[dy * ST_CC + dx]);
    const size_t oi = (((size_t)n * 64 + o) * R + gy) * R + gx;
    if (MODE == 0) {
      const int32_t* q = reinterpret_cast<const int32_t*>(table) + o * 4;
      const int v = (m * q[0] + q[1]) >> q[2];
      reinterpret_cast<int8_t*>(out)[oi] = (int8_t)min(max(v, 0), 127);
    } else {
      const float* fb = reinterpret_cast<const float*>(table);
      // no contraction: the reference rounds the product, then the sum
      const float v = __fadd_rn(__fmul_rn((float)m, fb[o]), fb[64 + o]);
      if (MODE == 1) {
        reinterpret_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16_rn(fmaxf(v, 0.f));
      } else {
        reinterpret_cast<int8_t*>(out)[oi] = (int8_t)(int)fminf(fmaxf(v, 0.f), 127.99f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// basic block
// ---------------------------------------------------------------------------
// One block = a BT x BT output tile of one image, all 64 channels.  The input
// tile (BT+4)^2 and the mid tile (BT+2)^2 sit in shared memory as 16 words
// (64 int8 channels) per pixel, padded to 17 words so that the threads of a
// warp, one pixel each, hit distinct banks.  Each thread accumulates all 64
// output channels of its pixel in registers; the weights of one tap are read
// as broadcasts (every thread the same address).  conv1 covers the whole mid
// tile (one thread per mid pixel, 16 x 16 = 256), conv2 the output tile.
constexpr int BT = 14;
constexpr int BM = BT + 2;                 // 16
constexpr int BI = BT + 4;                 // 18
constexpr int B_THREADS = BM * BM;         // 256
constexpr int PXW = 17;
constexpr int B_XIN_BYTES = BI * BI * PXW * 4;        // 22032
constexpr int B_MID_BYTES = BM * BM * PXW * 4;        // 17408
constexpr int B_W_BYTES = 9 * 64 * 64;                // 36864
constexpr int B_SMEM = B_XIN_BYTES + B_MID_BYTES + B_W_BYTES;
static_assert((B_XIN_BYTES + B_MID_BYTES) % 16 == 0, "weights 16B aligned");

__device__ __forceinline__ void conv3x3_px(const uint32_t* __restrict__ src, int row_px,
                                           const int32_t* __restrict__ ws, int acc[64]) {
#pragma unroll
  for (int o = 0; o < 64; ++o) acc[o] = 0;
  for (int t = 0; t < 9; ++t) {
    const uint32_t* p = src + ((t / 3) * row_px + (t % 3)) * PXW;
    int a[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) a[j] = (int)p[j];
    const int4* wt = reinterpret_cast<const int4*>(ws + t * 64 * 16);
#pragma unroll
    for (int o = 0; o < 64; ++o) {
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        const int4 w = wt[o * 4 + j4];
        acc[o] = __dp4a(a[4 * j4 + 0], w.x, acc[o]);
        acc[o] = __dp4a(a[4 * j4 + 1], w.y, acc[o]);
        acc[o] = __dp4a(a[4 * j4 + 2], w.z, acc[o]);
        acc[o] = __dp4a(a[4 * j4 + 3], w.w, acc[o]);
      }
    }
  }
}

__device__ __forceinline__ void load_weights(int32_t* ws, const int8_t* __restrict__ wp) {
  const int4* src = reinterpret_cast<const int4*>(wp);
  int4* dst = reinterpret_cast<int4*>(ws);
  for (int i = threadIdx.x; i < B_W_BYTES / 16; i += B_THREADS) dst[i] = src[i];
}

// clip(v, 0, 127.99) truncated to int8, as the reference's f32 -> int8 store
__device__ __forceinline__ uint32_t trunc_code(float v) {
  return (uint32_t)(int)fminf(fmaxf(v, 0.f), 127.99f);
}

template <bool LAST, bool TRUNC>
__global__ void __launch_bounds__(B_THREADS, 2)
block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1p,
             const void* __restrict__ q1, const int8_t* __restrict__ w2p,
             const void* __restrict__ e2, float sx, void* __restrict__ out,
             int R, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* xin = reinterpret_cast<uint32_t*>(smem);
  uint32_t* mid = reinterpret_cast<uint32_t*>(smem + B_XIN_BYTES);
  int32_t* ws = reinterpret_cast<int32_t*>(smem + B_XIN_BYTES + B_MID_BYTES);

  const int tid = threadIdx.x;
  const int n = blockIdx.x / (tiles * tiles);
  const int t = blockIdx.x % (tiles * tiles);
  const int y0 = (t / tiles) * BT, x0 = (t % tiles) * BT;
  const size_t plane = (size_t)R * R;
  const int8_t* xn = x + (size_t)n * 64 * plane;

  // input tile, zero outside the image (the conv's zero padding)
  for (int i = tid; i < BI * BI * 16; i += B_THREADS) {
    const int j = i / (BI * BI), p = i % (BI * BI);
    const int iy = y0 - 2 + p / BI, ix = x0 - 2 + p % BI;
    uint32_t wv = 0;
    if (iy >= 0 && iy < R && ix >= 0 && ix < R) {
      const int8_t* s = xn + (size_t)(4 * j) * plane + (size_t)iy * R + ix;
#pragma unroll
      for (int e = 0; e < 4; ++e) wv |= (uint32_t)(uint8_t)s[e * plane] << (8 * e);
    }
    xin[p * PXW + j] = wv;
  }
  load_weights(ws, w1p);
  __syncthreads();

  int acc[64];
  {
    // conv1 over the mid tile; mid pixels outside the image are conv2's
    // zero padding, not conv1 outputs
    const int my = tid / BM, mx = tid % BM;
    const int gy = y0 - 1 + my, gx = x0 - 1 + mx;
    uint32_t* dst = mid + tid * PXW;
    if (gy >= 0 && gy < R && gx >= 0 && gx < R) {
      conv3x3_px(xin + (my * BI + mx) * PXW, BI, ws, acc);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t wv = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 4 * j + e;
          if (TRUNC) {
            const float* fb = reinterpret_cast<const float*>(q1);
            // the product rounded, then the sum, as the reference's source reads
            wv |= trunc_code(__fadd_rn(__fmul_rn((float)acc[o], fb[o]), fb[64 + o])) << (8 * e);
          } else {
            const int32_t* q = reinterpret_cast<const int32_t*>(q1) + o * 4;
            const int v = (acc[o] * q[0] + q[1]) >> q[2];
            wv |= (uint32_t)min(max(v, 0), 127) << (8 * e);
          }
        }
        dst[j] = wv;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = 0u;
    }
  }
  __syncthreads();
  load_weights(ws, w2p);
  __syncthreads();

  if (tid < BT * BT) {
    const int oy = tid / BT, ox = tid % BT;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy < R && gx < R) {
      conv3x3_px(mid + (oy * BM + ox) * PXW, BM, ws, acc);
      const uint32_t* res = xin + ((oy + 2) * BI + (ox + 2)) * PXW;
      int8_t* o8 = reinterpret_cast<int8_t*>(out) + (size_t)n * 64 * plane + (size_t)gy * R + gx;
      __nv_bfloat16* o16 = reinterpret_cast<__nv_bfloat16*>(out) + (size_t)n * 64 * plane
                           + (size_t)gy * R + gx;
#pragma unroll
      for (int o = 0; o < 64; ++o) {
        const int r = (int)(int8_t)(res[o / 4] >> (8 * (o % 4)));
        if (LAST) {
          const float* fb = reinterpret_cast<const float*>(e2);
          // ((acc*f2 + b2) + res*sx) with every step rounded, as the reference
          const float v = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[o], fb[o]), fb[64 + o]),
                                    __fmul_rn((float)r, sx));
          o16[(size_t)o * plane] = __float2bfloat16_rn(fmaxf(v, 0.f));
        } else if (TRUNC) {
          const float* fb = reinterpret_cast<const float*>(e2);
          const float v = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[o], fb[o]), fb[64 + o]),
                                    __fmul_rn((float)r, sx));
          o8[(size_t)o * plane] = (int8_t)trunc_code(v);
        } else {
          const int32_t* q = reinterpret_cast<const int32_t*>(e2) + o * 4;
          const int v = (acc[o] * q[0] + q[1] + r * q[3]) >> q[2];
          o8[(size_t)o * plane] = (int8_t)min(max(v, 0), 127);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points (ctypes)
// ---------------------------------------------------------------------------

template <typename K>
static cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

extern "C" int stem_pool_requant(const void* x, const void* w148, const void* table,
                                 void* out, int n, int h, int mode, void* stream) {
  const int R = h / 4;
  const int tr = (R + ST_PR - 1) / ST_PR, tc = (R + ST_PC - 1) / ST_PC;
  const dim3 grid(n * tr * tc);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xi = reinterpret_cast<const int8_t*>(x);
  const int32_t* wi = reinterpret_cast<const int32_t*>(w148);
  cudaError_t e;
  switch (mode) {
    case 0:
      if ((e = allow_smem(stem_kernel<0>, ST_SMEM)) != cudaSuccess) return (int)e;
      stem_kernel<0><<<grid, ST_THREADS, ST_SMEM, s>>>(xi, wi, table, out, h, R, tr, tc);
      break;
    case 1:
      if ((e = allow_smem(stem_kernel<1>, ST_SMEM)) != cudaSuccess) return (int)e;
      stem_kernel<1><<<grid, ST_THREADS, ST_SMEM, s>>>(xi, wi, table, out, h, R, tr, tc);
      break;
    case 2:
      if ((e = allow_smem(stem_kernel<2>, ST_SMEM)) != cudaSuccess) return (int)e;
      stem_kernel<2><<<grid, ST_THREADS, ST_SMEM, s>>>(xi, wi, table, out, h, R, tr, tc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool LAST, bool TRUNC>
static int launch_block(const int8_t* x, const int8_t* w1, const void* q1, const int8_t* w2,
                        const void* e2, float sx, void* out, int n, int r, cudaStream_t s) {
  const int tiles = (r + BT - 1) / BT;
  const cudaError_t e = allow_smem(block_kernel<LAST, TRUNC>, B_SMEM);
  if (e != cudaSuccess) return (int)e;
  block_kernel<LAST, TRUNC><<<n * tiles * tiles, B_THREADS, B_SMEM, s>>>(
      x, w1, q1, w2, e2, sx, out, r, tiles);
  return (int)cudaGetLastError();
}

// last: bf16 out (exact f32 epilogue); trunc: the REQUANT = "trunc" int8 epilogues
extern "C" int basic_block(const void* x, const void* w1p, const void* q1, const void* w2p,
                           const void* e2, float sx, void* out, int n, int r, int last,
                           int trunc, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xi = reinterpret_cast<const int8_t*>(x);
  const int8_t* w1 = reinterpret_cast<const int8_t*>(w1p);
  const int8_t* w2 = reinterpret_cast<const int8_t*>(w2p);
  if (last) {
    return trunc ? launch_block<true, true>(xi, w1, q1, w2, e2, sx, out, n, r, s)
                 : launch_block<true, false>(xi, w1, q1, w2, e2, sx, out, n, r, s);
  }
  return trunc ? launch_block<false, true>(xi, w1, q1, w2, e2, sx, out, n, r, s)
               : launch_block<false, false>(xi, w1, q1, w2, e2, sx, out, n, r, s);
}
