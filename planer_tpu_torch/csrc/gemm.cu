// Hopper (sm_90a) kernel of the weight-only int8 / fp8 GEMM (dense_q).
//
// dense_q replaces planer_tpu/ops/pallas/gemm.py:_dense_q_kernel together with
// the cast and bias of gemm.py:dense_q: out = cast(bf16(x) . bf16(q)^T * scale)
// + bias, with x (M, Kd) bf16 (the wrapper rounds f32 x to bf16 first, the
// same round to nearest even the reference applies), q (N, Kd) int8 or
// float8_e4m3fn (one byte a weight either way), scale (N) f32, and the
// output and bias in float32 or bf16 (x's dtype before the wrapper's round).
// Both weight types are exact in bf16, as the reference's cast at gemm.py:59
// assumes: every int8 value is a bf16 value, and so is every e4m3 value
// (through cvt.rn.f16x2.e4m3x2, exact: it is an f16 value too).  The
// tensor cores run bf16 x bf16 -> f32 (wgmma), never fp8: an e4m3 product
// would need x in fp8, which the reference does not round it to.  Products of
// bf16 values are exact in f32 and summed in f32; the epilogue rounds
// acc * scale once (__fmul_rn), casts to the output dtype and adds the bias
// in that dtype, rounding once more, as the reference's cast-then-add does.
// The sum order differs from the reference's and from torch.matmul's, so
// results agree within the f32 rounding of the sums, not bit for bit.
//
// What bounds it on the H100 (3.35 TB/s, 989 bf16 TFLOP/s), counting x,
// the weights and the output once each: at ResNet-50's nine 1x1 shapes of
// batch 64, bytes for six (256->128, 512->128, 128->512, 512->256,
// 1024->256, 256->1024) and operations for three (1024->512, 2048->512,
// 512->2048: 2 Kd N flops per pixel against 2 Kd + 2 N bytes, above the
// ~295 flops per byte where the tensor cores become the limit).
//
// The design, against what held the first version (a cp.async tile GEMM)
// back:
//  1. x crosses shared memory once.  One producer thread brings x tiles (BP
//     pixels x 64 k, bf16, 128-byte swizzle) and the weight-byte tiles (128
//     channels x 64 k, 64-byte swizzle) with TMA into an mbarrier ring of
//     STAGES = 6; wgmma reads the x tile in place as its B operand.
//  2. K steps are 64 deep and have no block-wide barrier: each stage has a
//     full barrier (TMA's bytes landed) and an empty barrier (the 8
//     consumer warps are done with it).  The weights are the wgmma A
//     operand in registers: each thread reads its fragment's bytes from the
//     swizzled tile and decodes them (int8 by a magic-number add, e4m3 by
//     cvt) once per tile and K step, while the previous K step's wgmma
//     group runs; no bf16 copy of either operand goes through shared
//     memory.  The accumulator is (channels x pixels); the scale is per
//     accumulator row.
//  3. The epilogue transposes the tile through a swizzled staging buffer and
//     TMA stores whole (pixel, channel) rows; with two staging buffers
//     (bf16 out) the store drains while the next tile computes.  The grid is
//     persistent and the producer runs ahead across tiles, so one tile's
//     epilogue overlaps the next tile's loads.
//  4. The tile is 128 channels x BP pixels, BP = 128, or 64 where 128-pixel
//     tiles would be fewer than the SMs, chosen per shape on the host
//     (make_plan, copied by gemm.py:kernel_plan), so every path-4 shape of
//     batch 64 has at least one full wave of tiles without a K split.  One
//     384-thread block per SM: two consumer warpgroups (64 channels each)
//     and a producer warpgroup.
//  5. Neighbouring tiles share their x rows (channel tiles fastest), so the
//     N / 128 reads of an x tile after the first are L2 hits while the
//     card's blocks walk the same pixel rows.
// The M tail needs no predicates: TMA fills x rows past M with zeros and
// clips the stores there.  Kd and N are multiples of 128 by the wrapper's
// gate.
//
// The launch is on the caller's stream, allocates nothing, and the C entry
// point returns cudaGetLastError() (or the tensor-map encoder's failure as
// cudaErrorInvalidValue) for the wrapper to check.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

constexpr int BC = 128;            // channels per tile (two warpgroups of 64)
constexpr int BK = 64;             // k per stage: 128 bytes of bf16 x
constexpr int STAGES = 6;
constexpr int THREADS = 384;       // warpgroups 0-1 consume, warpgroup 2 loads
constexpr int WTILE = BC * BK;     // weight bytes per stage
enum WType { W_INT8 = 0, W_E4M3 = 1 };   // the C entry point's wdtype codes

template <int BP, typename TO>
struct Smem {
  static constexpr int XTILE = BP * BK * 2;                  // bf16 x per stage
  // the output tile in pieces of 128-byte rows (64 bf16 or 32 f32
  // channels), 128-byte swizzled, one TMA store each; two buffers for bf16
  // so a tile's store drains while the next tile is computed
  static constexpr int PIECE_CH = 128 / (int)sizeof(TO);
  static constexpr int PIECES = BC / PIECE_CH;
  static constexpr int OUTBUF = sizeof(TO) == 2 ? 2 : 1;
  static constexpr int OTILE = BP * BC * (int)sizeof(TO);
  static constexpr int W0 = STAGES * XTILE;                  // weight tiles
  static constexpr int OUT = W0 + STAGES * WTILE;            // output staging
  static constexpr int BAR = OUT + OUTBUF * OTILE;           // 2 * STAGES mbarriers
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + base alignment
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>   // all but the newest N store groups have read shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy shared-memory writes, made visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for A fragments: a wgmma reads them after it is issued, so they
// must stay live (not reallocated) until a wait shows the group complete
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
__device__ __forceinline__ void consumer_sync() {   // the 256 consumer threads
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wgmma descriptor of a K-major bf16 tile with 128-byte rows, 128-byte
// swizzle: start address >> 4, leading offset 1 (unused when swizzled),
// stride 1024 bytes between 8-row groups, layout 1 (128B swizzle)
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = (smem_u32(tile) & 0x3FFFF) >> 4;
  return a | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D(64 x 64) += A(64 x 16, registers) . B(16 x 64, shared memory, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) . B(16 x 128, shared memory, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// ---------------------------------------------------------------- decode
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // exact here
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two weight bytes (byte 0 -> the low half, the lower k) -> two bf16, exactly
template <int WT>
__device__ __forceinline__ uint32_t decode2(uint32_t v) {
  if constexpr (WT == W_INT8) {
    // byte b -> f32 2^23 + (b ^ 0x80) = 2^23 + 128 + int8(b), minus that
    // bias: int8(b) exactly; an integer of |v| <= 128 is its f32's top half
    const uint32_t u = v ^ 0x8080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  } else {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)v, __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);
  }
}

template <typename TO>
__device__ __forceinline__ TO out_cast(float v);
template <>
__device__ __forceinline__ float out_cast<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 out_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TO>
__device__ __forceinline__ TO epilogue(float acc, float s, bool has_bias, float b) {
  TO y = out_cast<TO>(__fmul_rn(acc, s));
  if (has_bias) y = out_cast<TO>(__fadd_rn(as_float(y), b));
  return y;
}

template <int BP>
__device__ __forceinline__ void wgmma_rs(float (&d)[BP / 2], const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (BP == 128) wgmma_rs_n128(d, a, desc);
  else wgmma_rs_n64(d, a, desc);
}

// The consumer warpgroups: wg owns channels [64 wg, 64 wg + 64) of each
// tile, and this thread's accumulator rows are channels r0 and r0 + 8.  Per
// K step (one ring stage, 64 k) the A fragments (m64k16: rows g / g + 8, k
// 2t, 2t+1 / 2t+8, 2t+9) of its four k16 steps are decoded from the
// swizzled weight bytes while the previous step's group of four wgmmas
// runs; a stage goes back to the producer when the group that read it is
// done.
template <int BP, typename TO, int WT>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ scale,
                                        const TO* __restrict__ bias, const CUtensorMap& omap,
                                        int M, int tiles, int tiles_n, int KT) {
  using S = Smem<BP, TO>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;
  const int swz = (r0 >> 1) & 3;             // the weight tile's 64-byte swizzle
  const bool has_bias = bias != nullptr;
  float acc[BP / 2];
  uint32_t fa[4][4] = {}, fb[4][4] = {};     // two K steps' A fragments
  int stage = 0;
  uint32_t phase = 0;

  auto step = [&](uint32_t (&a)[4][4]) {
    mbar_wait(&full[stage], phase);
    const unsigned char* wrow = smem + S::W0 + stage * WTILE + r0 * BK + 2 * t;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned char* c0 = wrow + ((s ^ swz) << 4);
      const unsigned char* c1 = c0 + 8 * BK;
      a[s][0] = decode2<WT>(*reinterpret_cast<const uint16_t*>(c0));
      a[s][1] = decode2<WT>(*reinterpret_cast<const uint16_t*>(c1));
      a[s][2] = decode2<WT>(*reinterpret_cast<const uint16_t*>(c0 + 8));
      a[s][3] = decode2<WT>(*reinterpret_cast<const uint16_t*>(c1 + 8));
    }
    const uint64_t desc = desc_sw128(smem + stage * S::XTILE);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_rs<BP>(acc, a[s], desc + 2 * s);   // +32 bytes of k
    wgmma_commit();
    fence_regs(acc);
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  auto advance = [&]() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  int ntile = 0;   // tiles done by this block: picks the staging buffer
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BP, n0 = (tile % tiles_n) * BC;
#pragma unroll
    for (int i = 0; i < BP / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < KT; kt += 2) {   // KT is even: Kd % 128 == 0
      step(fa);
      wgmma_wait<1>();    // the group that read fb is complete
      fence_regs(fb);
      if (prev >= 0) release(prev);
      prev = stage;
      advance();
      step(fb);
      wgmma_wait<1>();    // the group that read fa is complete
      fence_regs(fa);
      release(prev);
      prev = stage;
      advance();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fb);
    release(prev);

    // epilogue: scale, cast, bias into a staging buffer, whose pieces TMA
    // stores as (pixel, channel) rows; rows past M are clipped by TMA
    const int c0 = n0 + r0, c1 = c0 + 8;
    const float s0 = scale[c0], s1 = scale[c1];
    const float b0 = has_bias ? as_float(bias[c0]) : 0.f;
    const float b1 = has_bias ? as_float(bias[c1]) : 0.f;
    unsigned char* obuf = smem + S::OUT + (S::OUTBUF == 2 ? (ntile & 1) : 0) * S::OTILE;
    if (threadIdx.x == 0) bulk_wait_read<S::OUTBUF - 1>();   // this buffer's last store read it
    consumer_sync();
    // channel c of pixel row p: piece c / PIECE_CH, byte (c % PIECE_CH) * size
    // within the row, 16-byte chunk XOR (p % 8)
    auto put = [&](int p, int c, TO v) {
      unsigned char* row = obuf + (c / S::PIECE_CH) * (BP * 128) + p * 128;
      const int byte = (c % S::PIECE_CH) * (int)sizeof(TO);
      *reinterpret_cast<TO*>(row + (byte ^ ((p & 7) << 4))) = v;
    };
#pragma unroll
    for (int j = 0; j < BP / 8; ++j) {
      const int p = 8 * j + 2 * t;
      put(p, r0, epilogue<TO>(acc[4 * j + 0], s0, has_bias, b0));
      put(p + 1, r0, epilogue<TO>(acc[4 * j + 1], s0, has_bias, b0));
      put(p, r0 + 8, epilogue<TO>(acc[4 * j + 2], s1, has_bias, b1));
      put(p + 1, r0 + 8, epilogue<TO>(acc[4 * j + 3], s1, has_bias, b1));
    }
    fence_proxy_async();
    consumer_sync();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int h = 0; h < S::PIECES; ++h)
        tma_store_2d(&omap, obuf + h * (BP * 128), n0 + h * S::PIECE_CH, m0);
      bulk_commit();
    }
    ++ntile;
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// ---------------------------------------------------------------- kernel
template <int BP, typename TO, int WT>
__global__ void __launch_bounds__(THREADS, 1)
dense_q_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap omap, const float* __restrict__ scale,
               const TO* __restrict__ bias, int M, int N, int Kd) {
  using S = Smem<BP, TO>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA tiles and their wgmma descriptors need 1024-byte
  // aligned shared addresses
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* empty = full + STAGES;
  const int tiles_n = N / BC;
  const int tiles = ((M + BP - 1) / BP) * tiles_n;
  const int KT = Kd / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx; TMA's bytes
      mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= 8) {   // producer: one thread keeps the ring full, across tiles
    if (warp == 8 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BP, n0 = (tile % tiles_n) * BC;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], S::XTILE + WTILE);
          tma_load_2d(smem + stage * S::XTILE, &xmap, &full[stage], kt * BK, m0);
          tma_load_2d(smem + S::W0 + stage * WTILE, &wmap, &full[stage], kt * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    consume<BP, TO, WT>(smem, full, empty, scale, bias, omap, M, tiles, tiles_n, KT);
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {   // the driver's cuTensorMapEncodeTiled, without -lcuda
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) matrix of `esize`-byte elements, boxes of
// (box_rows, box_cols), zero fill past the edges
static bool tensor_map(CUtensorMap* m, const void* base, CUtensorMapDataType dt, int esize,
                       int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swz) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(m, dt, 2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// The per-shape plan (gemm.py:kernel_plan is its copy): 128-pixel tiles,
// or 64-pixel tiles where 128-pixel ones would leave SMs idle (fewer tiles
// than SMs); one persistent block per SM.
static void make_plan(int M, int N, int sms, int* bp, int* tiles, int* grid) {
  const long long tn = N / BC;
  const long long t128 = (M + 127LL) / 128 * tn, t64 = (M + 63LL) / 64 * tn;
  *bp = t128 >= sms ? 128 : 64;
  const long long t = *bp == 128 ? t128 : t64;
  *tiles = t > 0x7fffffffLL ? -1 : (int)t;
  *grid = (int)(t < sms ? t : sms);
}

template <int BP, typename TO, int WT>
static int launch(const void* x, const void* q, const void* scale, const void* bias, void* out,
                  int M, int N, int Kd, int grid, cudaStream_t s) {
  using S = Smem<BP, TO>;
  CUtensorMap xm, wm, om;
  const CUtensorMapDataType odt =
      sizeof(TO) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!tensor_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, Kd, BP, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&wm, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, Kd, BC, BK,
                  CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&om, out, odt, (int)sizeof(TO), M, N, BP, S::PIECE_CH,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;   // the shared-memory opt-in, once per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_q_kernel<BP, TO, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dense_q_kernel<BP, TO, WT><<<grid, THREADS, S::BYTES, s>>>(
      xm, wm, om, reinterpret_cast<const float*>(scale), reinterpret_cast<const TO*>(bias), M, N,
      Kd);
  return (int)cudaGetLastError();
}

template <typename TO, int WT>
static int launch_bp(const void* x, const void* q, const void* scale, const void* bias, void* out,
                     int M, int N, int Kd, int bp, int grid, cudaStream_t s) {
  return bp == 128 ? launch<128, TO, WT>(x, q, scale, bias, out, M, N, Kd, grid, s)
                   : launch<64, TO, WT>(x, q, scale, bias, out, M, N, Kd, grid, s);
}

template <typename TO>
static int launch_w(const void* x, const void* q, const void* scale, const void* bias, void* out,
                    int M, int N, int Kd, int wdtype, int bp, int grid, cudaStream_t s) {
  switch (wdtype) {
    case W_INT8:
      return launch_bp<TO, W_INT8>(x, q, scale, bias, out, M, N, Kd, bp, grid, s);
    case W_E4M3:
      return launch_bp<TO, W_E4M3>(x, q, scale, bias, out, M, N, Kd, bp, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The plan the kernel takes for (M, N): plan[0] = pixels per tile, plan[1] =
// tiles, plan[2] = blocks.  Returns 0, or an error code.
extern "C" int dense_q_plan(int M, int N, int Kd, int* plan) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorNoDevice;
  if (M <= 0 || N <= 0 || Kd <= 0 || N % BC || Kd % BK) return (int)cudaErrorInvalidValue;
  make_plan(M, N, sms, &plan[0], &plan[1], &plan[2]);
  return plan[1] > 0 ? 0 : (int)cudaErrorInvalidValue;
}

// x is bf16 (M, Kd); odtype: 0 = float32, 1 = bfloat16 (bias and out);
// wdtype: 0 = int8, 1 = e4m3 (q)
extern "C" int dense_q(const void* x, const void* q, const void* scale, const void* bias,
                       void* out, int M, int N, int Kd, int odtype, int wdtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int plan[3];
  const int e = dense_q_plan(M, N, Kd, plan);
  if (e) return e;
  if (((uintptr_t)x | (uintptr_t)q | (uintptr_t)out) & 15)   // TMA bases
    return (int)cudaErrorInvalidValue;
  switch (odtype) {
    case 0:
      return launch_w<float>(x, q, scale, bias, out, M, N, Kd, wdtype, plan[0], plan[2], s);
    case 1:
      return launch_w<__nv_bfloat16>(x, q, scale, bias, out, M, N, Kd, wdtype, plan[0], plan[2],
                                     s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
