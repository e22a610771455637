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
// What bounds them on the H100: at batch 64, 224, the stem does 15.1 GOP and
// a block 29.6 GOP of int8 MACs (2 ops each) against 22.5 and 25.7-38.5 MB of
// device-memory traffic, so both are operation-bound at the int8 tensor-core
// rate (1979 TOP/s: 7.6 and 15.0 us), with the stem's int32 accumulators and
// the block's mid plane kept in shared memory.  Both inner loops are implicit
// GEMMs on the tensor cores, mma.sync.m16n8k32 s8 x s8 -> s32 (M = pixels,
// N = the 64 output channels, K = taps x input channels), fed from shared
// memory by ldmatrix (6 per 16 MMAs) from layouts whose 8 rows of a matrix
// fall in distinct banks; integer sums are exact in any order, and every
// float epilogue rounds each step with __fmul_rn/__fadd_rn in the
// reference's order, so every plane equals the plain PyTorch version bit
// for bit.  After the MMA, what costs most is shared-memory traffic and
// latency between the phases of a tile: the stem's im2col gather (147 byte
// loads per conv pixel) and its pool reads, the byte-wise NCHW transposes
// on the way in and out of the block.  The stem's input patch streams in
// with cp.async one tile ahead; mma.sync reaches a fraction of the wgmma
// rate; wgmma with TMA is the next step (measured times: PERF.md).
//
// Both kernels are persistent: min(tiles, resident blocks per SM x SMs)
// blocks walk the tiles, so each block loads its weights into shared memory
// once, not once per tile.  Shared memory per block:
//   stem   94,976 B (2 blocks per SM): weights 64 x 160 (K = 147 taps in the
//          weights' (c, ky, kx) order and 13 zeros) at a 176-byte pitch,
//          tables, two 3 x 35 x 44 input patches (this tile's and the
//          next's), then one region used first as the A tile (256 rows x
//          160 B, 176-byte pitch) and then as the int32 accumulator plane
//          (channel-last, 255 pixels x 72 words).  The pooled
//          tile is 7 x 8, so the conv tile is 15 x 17 = 255 pixels: 16
//          m-tiles of 16 rows with one pad row, 1.14x the needed conv work.
//   block 112,896 B (2 blocks per SM): both convs' weights resident
//          (2 x 36,864 B, [tap][o][c]), the 18 x 18 input tile and the
//          16 x 16 mid tile, channel-last with 64 B per pixel, 16-byte chunk
//          j of row r stored at chunk j ^ ((r >> 1) & 3).  The output tile
//          is T = 14: the mid tile is then 16 x 16 = exactly 16 m-tiles (one
//          mid row each) and two blocks fit an SM; conv1's halo work is
//          1.31x and conv2 pads 196 pixels to 208 rows.  T = 28 would cut
//          the halo to 1.15x but needs 195 KB, one block per SM, with no
//          second block to overlap the load and store phases.
//
// Every launch is on the caller's stream, allocates nothing, and the C entry
// points return the first CUDA error for the wrapper to check.  Layouts: all
// global activations are NCHW; weights come pre-packed by the host
// (ops/kernels/stage64.py: _pack_stem, _pack_block).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NEG_SENTINEL = -(1 << 30);

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory: lanes 8j..8j+7 give the 16-byte
// rows of matrix j, and register j of lane l receives bytes 4*(l%4)..+3 of
// its row l/4 - for int8, exactly the m16n8k32 fragment word of that row
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const unsigned char* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 4 bytes global -> shared, zero-filled when !valid (0 bytes read)
__device__ __forceinline__ void cp_async4(unsigned char* smem, const void* gmem, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// byte offset of 16-byte chunk `chunk` (0-3) of 64-byte row r: the chunks are
// XOR-swizzled so that any 8 consecutive rows read at one chunk cover all 32
// banks (r & 1 picks the half of the bank space, (r >> 1) & 3 the chunk)
__device__ __forceinline__ int swz(int r, int chunk) {
  return (r << 6) | ((chunk ^ ((r >> 1) & 3)) << 4);
}

// clip(v, 0, 127.99) truncated to int8, as the reference's f32 -> int8 store
__device__ __forceinline__ int trunc_code(float v) {
  return (int)fminf(fmaxf(v, 0.f), 127.99f);
}

// ---------------------------------------------------------------------------
// stem
// ---------------------------------------------------------------------------
constexpr int ST_PR = 7;                        // pooled tile rows
constexpr int ST_PC = 8;                        // pooled tile cols
constexpr int ST_CR = 2 * ST_PR + 1;            // 15 conv rows
constexpr int ST_CC = 2 * ST_PC + 1;            // 17 conv cols
constexpr int ST_NPIX = ST_CR * ST_CC;          // 255 conv pixels = GEMM rows
constexpr int ST_IR = 2 * (ST_CR - 1) + 7;      // 35 input rows
constexpr int ST_IW = 11;                       // input words per row: cols ic0-3 .. ic0+40
constexpr int ST_ICP = 4 * ST_IW;               // 44: input row pitch (bytes)
constexpr int ST_K = 160;                       // 147 taps + 13 zeros: 5 k-steps
constexpr int ST_KP = 176;                      // A and W row pitch (bytes)
constexpr int ST_PXP = 72;                      // plane pitch per conv pixel (words)
constexpr int ST_THREADS = 256;                 // 8 warps x 2 m-tiles x 64 channels
constexpr int ST_W_BYTES = 64 * ST_KP;                          // 11264
constexpr int ST_TAB_BYTES = 64 * 16;                           // 1024
constexpr int ST_XS_BYTES = (3 * ST_IR * ST_ICP + 15) / 16 * 16;  // 4624, two of them
constexpr int ST_A_BYTES = 256 * ST_KP;                         // 45056
constexpr int ST_ACC_BYTES = ST_NPIX * ST_PXP * 4;             // 73440
constexpr int ST_WORK_BYTES = ST_A_BYTES > ST_ACC_BYTES ? ST_A_BYTES : ST_ACC_BYTES;
constexpr int ST_SMEM = ST_W_BYTES + ST_TAB_BYTES + 2 * ST_XS_BYTES + ST_WORK_BYTES;
static_assert(ST_NPIX <= 256 && ST_THREADS == 256, "one A row per thread, 16 m-tiles");
static_assert(ST_PXP % 32 == 8, "conflict-free plane stores and pool reads");

// the input patch of a tile: 3 channels x 35 rows x 11 words, each word
// 4-byte aligned in the image (H % 4 == 0), so a word is wholly inside or
// wholly outside it; cp.async zero-fills the words outside
__device__ __forceinline__ void stem_load_patch(unsigned char* xs, const int8_t* __restrict__ x,
                                                int tile, int H, int tiles_r, int tiles_c) {
  const int n = tile / (tiles_r * tiles_c);
  const int t = tile % (tiles_r * tiles_c);
  const int ir0 = 4 * (t / tiles_c) * ST_PR - 5;    // 2 * (2 * pr0 - 1) - 3
  const int iw0 = 4 * (t % tiles_c) * ST_PC - 8;    // first col (ic0 - 3), 4-aligned
  const int8_t* xn = x + (size_t)n * 3 * H * H;
  for (int i = threadIdx.x; i < 3 * ST_IR * ST_IW; i += ST_THREADS) {
    const int c = i / (ST_IR * ST_IW);
    const int rem = i % (ST_IR * ST_IW);
    const int iy = ir0 + rem / ST_IW, ix = iw0 + 4 * (rem % ST_IW);
    const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < H;
    cp_async4(xs + (c * ST_IR + rem / ST_IW) * ST_ICP + 4 * (rem % ST_IW),
              ok ? xn + ((size_t)c * H + iy) * H + ix : x, ok);
  }
}

template <int MODE>
__global__ void __launch_bounds__(ST_THREADS, 2)
stem_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w160,
            const void* __restrict__ table, void* __restrict__ out,
            int H, int R, int tiles_r, int tiles_c, int total) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ws = smem;
  unsigned char* tab = ws + ST_W_BYTES;
  unsigned char* xsb = tab + ST_TAB_BYTES;        // two patch buffers
  unsigned char* work = xsb + 2 * ST_XS_BYTES;
  int32_t* accp = reinterpret_cast<int32_t*>(work);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int Hc = H / 2;                    // stem conv output side

  for (int i = tid; i < 64 * (ST_K / 16); i += ST_THREADS)
    *reinterpret_cast<int4*>(ws + (i / 10) * ST_KP + 16 * (i % 10)) =
        reinterpret_cast<const int4*>(w160)[i];
  for (int i = tid; i < (MODE == 0 ? 64 : 32); i += ST_THREADS)
    reinterpret_cast<int4*>(tab)[i] = reinterpret_cast<const int4*>(table)[i];

  // the ldmatrix row this lane addresses: A rows (l & 7) + 8 * ((l >> 3) & 1)
  // at chunk l >> 4; B rows (l & 7) + 8 * (l >> 4) at chunk (l >> 3) & 1
  const unsigned char* a_lane = work + (32 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * ST_KP
                                + 16 * (lane >> 4);
  const unsigned char* b_lane = ws + ((lane & 7) + 8 * (lane >> 4)) * ST_KP + 16 * ((lane >> 3) & 1);

  if (blockIdx.x < total) stem_load_patch(xsb, x, blockIdx.x, H, tiles_r, tiles_c);
  cp_async_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, buf ^= 1) {
    const int n = tile / (tiles_r * tiles_c);
    const int t = tile % (tiles_r * tiles_c);
    const int pr0 = (t / tiles_c) * ST_PR;
    const int pc0 = (t % tiles_c) * ST_PC;
    const int cr0 = 2 * pr0 - 1, cc0 = 2 * pc0 - 1;   // first conv row / col
    const unsigned char* xs = xsb + buf * ST_XS_BYTES;

    // the next tile's patch streams in while this one is computed; its
    // buffer was last read by the gather two barriers ago
    if (tile + gridDim.x < total)
      stem_load_patch(xsb + (buf ^ 1) * ST_XS_BYTES, x, tile + gridDim.x, H, tiles_r, tiles_c);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();          // this patch has landed; the previous pool is done

    // A tile: row = conv pixel, its 7x7x3 patch in the weights' flat
    // (c, ky, kx) order, 4 taps per word, zero past tap 147
    {
      uint4* arow = reinterpret_cast<uint4*>(work + tid * ST_KP);
      if (tid < ST_NPIX) {
        const unsigned char* base = xs + 2 * (tid / ST_CC) * ST_ICP + 2 * (tid % ST_CC) + 3;
#pragma unroll
        for (int q = 0; q < ST_K / 16; ++q) {
          uint32_t wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t v = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = 16 * q + 4 * j + e;
              if (k < 147) {
                const int c = k / 49, ky = (k / 7) % 7, kx = k % 7;
                v |= (uint32_t)base[(c * ST_IR + ky) * ST_ICP + kx] << (8 * e);
              }
            }
            wv[j] = v;
          }
          arow[q] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < ST_K / 16; ++q) arow[q] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();

    // GEMM: warp w takes rows 32w .. 32w+31 (2 m-tiles) x all 64 channels
    int acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
#pragma unroll
    for (int ks = 0; ks < ST_K / 32; ++ks) {
      uint32_t a[2][4];
      ldsm_x4(a[0], a_lane + 32 * ks);
      ldsm_x4(a[1], a_lane + 16 * ST_KP + 32 * ks);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_lane + 16 * np * ST_KP + 32 * ks);
        mma_s8(acc[0][2 * np], a[0], b[0], b[1]);
        mma_s8(acc[1][2 * np], a[1], b[0], b[1]);
        mma_s8(acc[0][2 * np + 1], a[0], b[2], b[3]);
        mma_s8(acc[1][2 * np + 1], a[1], b[2], b[3]);
      }
    }
    __syncthreads();          // the A tile is read: its region becomes the plane

    // the plane, channel-last: accumulator e of an m16n8 tile is row
    // g + 8*(e/2), column 2*t4 + e%2, so a lane stores 2 channels at once;
    // conv pixels outside the image hold the pool's sentinel
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * warp + 16 * mi + g + 8 * h;
        if (row >= ST_NPIX) continue;
        const int cy = cr0 + row / ST_CC, cx = cc0 + row % ST_CC;
        const bool inside = cy >= 0 && cy < Hc && cx >= 0 && cx < Hc;
        int2* dst = reinterpret_cast<int2*>(accp + row * ST_PXP + 2 * t4);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          dst[4 * ni] = inside ? make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1])
                               : make_int2(NEG_SENTINEL, NEG_SENTINEL);
      }
    }
    __syncthreads();

    // pool + requant, 4 channels per lane: a warp takes 4 channel quads x
    // 8 pooled columns of one pooled row (the 128-bit reads of 8 lanes are
    // 2 pixels x 4 quads: 32 banks; the stores 4 planes x 8 bytes)
    for (int i = tid; i < 16 * ST_PR * ST_PC; i += ST_THREADS) {
      const int ql = i & 3, pc = (i >> 2) & 7;
      const int pr = (i >> 5) % ST_PR, quad = 4 * ((i >> 5) / ST_PR) + ql;
      const int gy = pr0 + pr, gx = pc0 + pc;
      if (gy >= R || gx >= R) continue;
      const int4* a = reinterpret_cast<const int4*>(accp + (2 * pr * ST_CC + 2 * pc) * ST_PXP) + quad;
      int4 m = make_int4(NEG_SENTINEL, NEG_SENTINEL, NEG_SENTINEL, NEG_SENTINEL);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int4 v = a[(dy * ST_CC + dx) * (ST_PXP / 4)];
          m = make_int4(max(m.x, v.x), max(m.y, v.y), max(m.z, v.z), max(m.w, v.w));
        }
      const int mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = 4 * quad + j;
        const size_t oi = (((size_t)n * 64 + o) * R + gy) * R + gx;
        if (MODE == 0) {
          const int4 q = reinterpret_cast<const int4*>(tab)[o];
          const int v = (mv[j] * q.x + q.y) >> q.z;
          reinterpret_cast<int8_t*>(out)[oi] = (int8_t)min(max(v, 0), 127);
        } else {
          const float* fb = reinterpret_cast<const float*>(tab);
          // no contraction: the reference rounds the product, then the sum
          const float v = __fadd_rn(__fmul_rn((float)mv[j], fb[o]), fb[64 + o]);
          if (MODE == 1) {
            reinterpret_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16_rn(fmaxf(v, 0.f));
          } else {
            reinterpret_cast<int8_t*>(out)[oi] = (int8_t)trunc_code(v);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// basic block
// ---------------------------------------------------------------------------
constexpr int BT = 14;                     // output tile side
constexpr int BMID = BT + 2;               // 16: mid tile side = one m-tile per mid row
constexpr int BI = BT + 4;                 // 18: input tile side
constexpr int B_THREADS = 256;             // 8 warps
constexpr int B_OUT = BT * BT;             // 196 output pixels: conv2 rows
constexpr int B_MT2 = (B_OUT + 15) / 16;   // 13 conv2 m-tiles
constexpr int B_W_BYTES = 9 * 64 * 64;     // 36864 per conv
constexpr int B_TAB_BYTES = 64 * 16;       // 1024 per table
constexpr int B_XIN_BYTES = BI * BI * 64;  // 20736
constexpr int B_MID_BYTES = BMID * BMID * 64;   // 16384
constexpr int B_SP = 200;                  // staged output pitch (elements)
constexpr int B_SMEM = 2 * B_W_BYTES + 2 * B_TAB_BYTES + B_XIN_BYTES + B_MID_BYTES;
static_assert(64 * B_SP * 2 <= B_XIN_BYTES + B_MID_BYTES, "bf16 staging fits in the tiles");
static_assert(B_MT2 <= 2 * (B_THREADS / 32), "conv2: at most 2 m-tiles per warp");

// acc[mi] += (m-tile mi of this warp) x W over K = 9 taps x 64 channels.
// This lane addresses (for ldmatrix) row (lane & 7) + 8 * ((lane >> 3) & 1)
// of m-tile mi, whose source pixel at tap (dy, dx) is px[mi] + dy*SW + dx:
// implicit im2col, a tap is an address offset.  B: the lane addresses row
// tap*64 + 16np + (lane & 7) + 8 * (lane >> 4) at chunk (lane >> 3) & 1.
template <int SW>
__device__ __forceinline__ void conv3x3_mma(const unsigned char* __restrict__ src,
                                            const unsigned char* __restrict__ w,
                                            const int px[2], bool two, int acc[2][8][4],
                                            int lane) {
  const int a_chunk = lane >> 4;
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const unsigned char* b_lane = w + b_row * 64;
  const int b_sw = (b_row >> 1) & 3, b_chunk = (lane >> 3) & 1;
  // not unrolled: with all 9 taps in view the compiler hoists their
  // addresses and loads past the 128-register budget of 2 blocks per SM
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const int off = (t / 3) * SW + (t % 3);
    const unsigned char* wt = b_lane + t * 64 * 64;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t a[2][4];
      ldsm_x4(a[0], src + swz(px[0] + off, 2 * kh + a_chunk));
      if (two) ldsm_x4(a[1], src + swz(px[1] + off, 2 * kh + a_chunk));
      const int b_off = ((2 * kh + b_chunk) ^ b_sw) << 4;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, wt + np * 16 * 64 + b_off);
        mma_s8(acc[0][2 * np], a[0], b[0], b[1]);
        mma_s8(acc[0][2 * np + 1], a[0], b[2], b[3]);
        if (two) {
          mma_s8(acc[1][2 * np], a[1], b[0], b[1]);
          mma_s8(acc[1][2 * np + 1], a[1], b[2], b[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(int acc[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
}

template <bool LAST, bool TRUNC>
__global__ void __launch_bounds__(B_THREADS, 2)
block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1p,
             const void* __restrict__ q1, const int8_t* __restrict__ w2p,
             const void* __restrict__ e2, float sx, void* __restrict__ out,
             int R, int tiles, int total) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ws1 = smem;
  unsigned char* ws2 = ws1 + B_W_BYTES;
  unsigned char* tab1 = ws2 + B_W_BYTES;
  unsigned char* tab2 = tab1 + B_TAB_BYTES;
  unsigned char* xin = tab2 + B_TAB_BYTES;
  unsigned char* mid = xin + B_XIN_BYTES;
  unsigned char* stage = xin;              // the output tile, once both convs are done

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t plane = (size_t)R * R;

  // both convs' weights, [tap][o][c] rows of 64 B, once per block
  for (int i = tid; i < 2 * 9 * 64 * 4; i += B_THREADS) {
    const int cv = i / (9 * 64 * 4), k = i % (9 * 64 * 4);
    const int4 v = reinterpret_cast<const int4*>(cv ? w2p : w1p)[k];
    *reinterpret_cast<int4*>((cv ? ws2 : ws1) + swz(k >> 2, k & 3)) = v;
  }
  // fxp tables are (64, 4) int32, f32 tables (2, 64) rows f, b
  for (int i = tid; i < (TRUNC ? 32 : 64); i += B_THREADS)
    reinterpret_cast<int4*>(tab1)[i] = reinterpret_cast<const int4*>(q1)[i];
  for (int i = tid; i < ((LAST || TRUNC) ? 32 : 64); i += B_THREADS)
    reinterpret_cast<int4*>(tab2)[i] = reinterpret_cast<const int4*>(e2)[i];

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int n = tile / (tiles * tiles);
    const int t = tile % (tiles * tiles);
    const int y0 = (t / tiles) * BT, x0 = (t % tiles) * BT;
    const int8_t* xn = x + (size_t)n * 64 * plane;

    __syncthreads();          // the previous tile's output has left the staging area
    // input tile, zero outside the image (the conv's zero padding): one
    // thread gathers 16 channel planes of one pixel into one 16-byte chunk
    for (int i = tid; i < BI * BI * 4; i += B_THREADS) {
      const int j = i / (BI * BI), p = i % (BI * BI);
      const int iy = y0 - 2 + p / BI, ix = x0 - 2 + p % BI;
      uint32_t wv[4] = {0u, 0u, 0u, 0u};
      if (iy >= 0 && iy < R && ix >= 0 && ix < R) {
        const int8_t* s = xn + (size_t)(16 * j) * plane + (size_t)iy * R + ix;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          wv[c >> 2] |= (uint32_t)(uint8_t)__ldg(s + c * plane) << (8 * (c & 3));
      }
      *reinterpret_cast<uint4*>(xin + swz(p, j)) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
    __syncthreads();

    int acc[2][8][4];
    // conv1 over the 16 x 16 mid tile: warp w takes mid rows 2w and 2w+1
    const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);     // this lane's ldmatrix row
    {
      const int px[2] = {2 * warp * BI + lrow, (2 * warp + 1) * BI + lrow};
      zero_acc(acc);
      conv3x3_mma<BI>(xin, ws1, px, true, acc, lane);
    }
    // requant into the mid tile; mid pixels outside the image are conv2's
    // zero padding, not conv1 outputs
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int o = 8 * ni + 2 * t4;
      int4 q[2];
      float f[2], b[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (TRUNC) {
          f[e] = reinterpret_cast<const float*>(tab1)[o + e];
          b[e] = reinterpret_cast<const float*>(tab1)[64 + o + e];
        } else {
          q[e] = reinterpret_cast<const int4*>(tab1)[o + e];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int my = 2 * warp + mi, mx = g + 8 * h;
          const int gy = y0 - 1 + my, gx = x0 - 1 + mx;
          uint32_t pair = 0;
          if (gy >= 0 && gy < R && gx >= 0 && gx < R) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int a = acc[mi][ni][2 * h + e];
              int v;
              if (TRUNC) {
                // the product rounded, then the sum, as the reference's source reads
                v = trunc_code(__fadd_rn(__fmul_rn((float)a, f[e]), b[e]));
              } else {
                v = min(max((a * q[e].x + q[e].y) >> q[e].z, 0), 127);
              }
              pair |= (uint32_t)v << (8 * e);
            }
          }
          *reinterpret_cast<uint16_t*>(mid + swz(my * BMID + mx, o >> 4) + (o & 15)) = (uint16_t)pair;
        }
      }
    }
    __syncthreads();

    // conv2 over the 14 x 14 output tile (196 rows in 13 m-tiles): warp w
    // takes m-tiles w and w + 8; rows past 195 read pixel 195 and are dropped
    const bool two = warp + 8 < B_MT2;
    {
      int px[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = min((warp + 8 * mi) * 16 + lrow, B_OUT - 1);
        px[mi] = (m / BT) * BMID + m % BT;
      }
      zero_acc(acc);
      conv3x3_mma<BMID>(mid, ws2, px, two, acc, lane);
    }
    // epilogue with the residual from the input tile; the result (int8 code
    // or bf16 bits) replaces the accumulator until the tiles are free
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int o = 8 * ni + 2 * t4;
      int4 q[2];
      float f[2], b[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (LAST || TRUNC) {
          f[e] = reinterpret_cast<const float*>(tab2)[o + e];
          b[e] = reinterpret_cast<const float*>(tab2)[64 + o + e];
        } else {
          q[e] = reinterpret_cast<const int4*>(tab2)[o + e];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi == 1 && !two) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = min((warp + 8 * mi) * 16 + g + 8 * h, B_OUT - 1);
          const int rp = (m / BT + 2) * BI + m % BT + 2;
          const uint32_t res = *reinterpret_cast<const uint16_t*>(xin + swz(rp, o >> 4) + (o & 15));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = acc[mi][ni][2 * h + e];
            const int r = (int)(int8_t)(res >> (8 * e));
            int v;
            if (LAST || TRUNC) {
              // ((acc*f2 + b2) + res*sx) with every step rounded, as the reference
              const float y = __fadd_rn(__fadd_rn(__fmul_rn((float)a, f[e]), b[e]),
                                        __fmul_rn((float)r, sx));
              if (LAST) {
                v = (int)__bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(y, 0.f)));
              } else {
                v = trunc_code(y);
              }
            } else {
              v = min(max((a * q[e].x + q[e].y + r * q[e].w) >> q[e].z, 0), 127);
            }
            acc[mi][ni][2 * h + e] = v;
          }
        }
      }
    }
    __syncthreads();          // every warp is done with the mid and input tiles

    // stage the tile channel-major, then write each channel plane's rows
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (mi == 1 && !two) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (warp + 8 * mi) * 16 + g + 8 * h;
        if (m >= B_OUT) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = 8 * ni + 2 * t4 + e;
            if (LAST) {
              reinterpret_cast<uint16_t*>(stage)[o * B_SP + m] = (uint16_t)acc[mi][ni][2 * h + e];
            } else {
              stage[o * B_SP + m] = (unsigned char)acc[mi][ni][2 * h + e];
            }
          }
      }
    }
    __syncthreads();
    // two neighbouring pixels per store: with R, x0 and the column even, a
    // pair never leaves its row and is 2-element aligned
    for (int i = tid; i < 64 * B_OUT / 2; i += B_THREADS) {
      const int o = i / (B_OUT / 2), m = 2 * (i % (B_OUT / 2));
      const int gy = y0 + m / BT, gx = x0 + m % BT;
      if (gy >= R || gx >= R) continue;
      const size_t oi = ((size_t)n * 64 + o) * plane + (size_t)gy * R + gx;
      if (LAST) {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<uint16_t*>(out) + oi) =
            *reinterpret_cast<const uint32_t*>(reinterpret_cast<const uint16_t*>(stage) + o * B_SP + m);
      } else {
        *reinterpret_cast<uint16_t*>(reinterpret_cast<unsigned char*>(out) + oi) =
            *reinterpret_cast<const uint16_t*>(stage + o * B_SP + m);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

// a persistent grid: as many blocks as fit on the card at once, at most one
// per tile
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, int smem, int tiles, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  return cudaSuccess;
}

template <int MODE>
int launch_stem(const int8_t* x, const int8_t* w, const void* table, void* out, int n, int h,
                cudaStream_t s) {
  const int R = h / 4;
  const int tr = (R + ST_PR - 1) / ST_PR, tc = (R + ST_PC - 1) / ST_PC;
  const int total = n * tr * tc;
  int grid = 0;
  const cudaError_t e = persistent_grid(stem_kernel<MODE>, ST_THREADS, ST_SMEM, total, &grid);
  if (e != cudaSuccess) return (int)e;
  stem_kernel<MODE><<<grid, ST_THREADS, ST_SMEM, s>>>(x, w, table, out, h, R, tr, tc, total);
  return (int)cudaGetLastError();
}

template <bool LAST, bool TRUNC>
int launch_block(const int8_t* x, const int8_t* w1, const void* q1, const int8_t* w2,
                 const void* e2, float sx, void* out, int n, int r, cudaStream_t s) {
  const int tiles = (r + BT - 1) / BT;
  const int total = n * tiles * tiles;
  int grid = 0;
  const cudaError_t e = persistent_grid(block_kernel<LAST, TRUNC>, B_THREADS, B_SMEM, total, &grid);
  if (e != cudaSuccess) return (int)e;
  block_kernel<LAST, TRUNC><<<grid, B_THREADS, B_SMEM, s>>>(x, w1, q1, w2, e2, sx, out, r, tiles,
                                                            total);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes)
// ---------------------------------------------------------------------------

// x (n, 3, h, h) int8; w160 (64, 160) int8: the (64, 3, 7, 7) weights in
// their flat (c, ky, kx) order and 13 zeros; table (64, 4) int32 (mode 0) or
// (2, 64) f32 (modes 1, 2); out (n, 64, h/4, h/4) int8 or bf16 (mode 1)
extern "C" int stem_pool_requant(const void* x, const void* w160, const void* table,
                                 void* out, int n, int h, int mode, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xi = reinterpret_cast<const int8_t*>(x);
  const int8_t* wi = reinterpret_cast<const int8_t*>(w160);
  switch (mode) {
    case 0: return launch_stem<0>(xi, wi, table, out, n, h, s);
    case 1: return launch_stem<1>(xi, wi, table, out, n, h, s);
    case 2: return launch_stem<2>(xi, wi, table, out, n, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x (n, 64, r, r) int8, r even (every eligible stage side is); w1p, w2p
// (9, 64, 64) int8 [tap][o][c]; q1 and e2 the
// fxp (64, 4) int32 or f32 (2, 64) tables; last: bf16 out (exact f32
// epilogue); trunc: the REQUANT = "trunc" int8 epilogues
extern "C" int basic_block(const void* x, const void* w1p, const void* q1, const void* w2p,
                           const void* e2, float sx, void* out, int n, int r, int last,
                           int trunc, void* stream) {
  if (r % 2) return (int)cudaErrorInvalidValue;    // the stores take pixel pairs
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
