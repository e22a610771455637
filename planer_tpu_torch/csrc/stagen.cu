// Hopper (sm_90a) kernel of the fused ResNet body stages (stagen).
//
// Replaces planer_tpu/ops/pallas/stagen.py:_stagen_kernel.  The TPU kernel
// runs a whole stage (basic or bottleneck blocks, a stride-2 entry, a 1x1
// projection) per grid step with every plane in VMEM.  A stage does not fit
// in one SM's 227 KB of shared memory (ResNet-50 layer1 is 800 KB of int8
// per image), so here the wrapper (ops/kernels/stagen.py) launches this
// kernel once per residual block: only a block's input and output cross
// device memory, and the block's intermediate planes (t1 and t2 of a
// bottleneck, the mid plane of a basic block, the requantized projection
// residual) live in shared memory, per output tile.
//
// What it computes, each step rounded in the reference's order
// (__fmul_rn/__fadd_rn, which nvcc does not contract), so every plane equals
// the plain PyTorch version (stagen_plain) bit for bit:
//   t1, t2, mid      clamp(acc*f + b, 0, 127.99) truncated to int8 (b holds
//                    the folded +0.5); a pixel outside the image is 0: it is
//                    the next conv's zero padding, not an epilogue of zeros;
//   projection       clamp(floor(acc*f + b), -127, 127) to int8;
//   block sum        (acc*f + b) + res*sx, clipped and truncated to int8, or
//                    in the stage's last block ReLU'd to bf16, NCHW.
//
// What bounds it on the H100: at batch 64 a stage of ResNet-18/50 at 224 is
// 53-132 GOP of int8 MACs against 26-116 MB of input, weights and output, so
// it is operation-bound at the int8 tensor-core rate (1979 TOP/s) once the
// intermediate planes stay on chip.  Design:
//   * a persistent grid (one 512-thread block per SM) walks output tiles
//     (14 x 14 pixels; 7 x 14 for the strided bottleneck entry).  A tile's
//     input region (the halo the block's chain of convs needs, zero outside
//     the image) is loaded into shared memory with cp.async (in a stage's
//     first block, from the stage's int8 NCHW codes, 16 channels of a pixel
//     per thread: no transposed copy of the input); an identity block
//     streams the next tile's region in, slab by slab, as soon as the last
//     pass that reads a slab (its residual) is done.  Then the chain
//     runs: each conv an implicit GEMM (M = the tile's pixels, N = 64
//     output channels per pass, K = taps x 64-channel slabs) on
//     mma.sync.m16n8k32 s8 x s8 -> s32, each of 16 warps taking up to two
//     m-tiles x 32 channels, fed by ldmatrix from channel-last planes whose
//     16-byte chunk j of pixel row p sits at chunk j ^ ((p >> 1) & 3), so 8
//     consecutive rows read at one chunk cover all 32 banks;
//   * the first conv runs on the halo the 3x3 after it needs (the 16 x 16
//     region of a 14 x 14 tile: 1.31x its work), as stage64's block kernel;
//   * a stride-2 conv reads its source plane in the TPU's phase order (four
//     (y & 1, x & 1) planes, planer_tpu/ops/pallas/stagen.py:_s2d_taps), so
//     every tap reads unit-stride rows;
//   * the weights stream through a ring of NB 4 KB slices (64 outputs x 64
//     input channels each), one bulk copy per slice completing on an
//     mbarrier.  The host packs every slice of the block, pre-swizzled, in
//     the exact order the kernel consumes them
//     (ops/kernels/stagen.py:_pack_stream), so the stream is one contiguous
//     buffer read cyclically, tile after tile;
//   * the last 1x1 runs in passes of 64 output channels; the projection of
//     an entry block is computed first for the same 64 channels and
//     requantized into shared memory, so one int32 accumulator is live;
//   * each pass's output is staged in shared memory (channel-last int8 rows,
//     or channel-major bf16 for the NCHW plane) and written as 16-byte rows
//     (int8 NHWC) or pixel pairs (bf16 NCHW).
//
// Wide blocks (WIDE): where the input region at all cin channels does not
// fit beside the planes (ResNet-50 layers 3-4, ResNet-18 layer 3's entry and
// layer 4, eligible above 224), the region is not held resident.  It streams
// through a ring of XR (2, or 1 where two do not fit) 64-channel slabs by
// cp.async (from a stage's NCHW codes the tile's first pass gathers each
// slab, 16 channels of a pixel per thread, and keeps its image in the
// block's part of a scratch buffer, which the later passes copy back by
// cp.async): each pass of the first conv
// reads the tile's region slab by slab, every tap of a slab before the next
// (the stream packs those slices slab-major); a slab is dropped once its
// pass is through it (the tile's region stays L2-hot between passes).  An
// entry block then loads its projection's input, only the tile's own input
// pixels at every slab, into the slots' place, once per tile.  The
// identity residual is read per 64-channel output pass from device memory
// for the tile's output pixels.  Tiles are shorter where t1, mid or t2 at
// cmid / cout channels would not fit (TH rows of 14: Geo).  The arithmetic,
// the planes, the weight ring and the epilogues are the resident forms'.
// The wrapper picks each block's geometry (stagen._GEOMETRIES, the first
// that fits 227 KB by stagen_block_smem, the layout both share).
//
// Layouts: x int8 NHWC (n, h, h, cin), or in a stage's first block the
// stage's int8 NCHW codes, read in place; out int8 NHWC (n, r, r, cout) or
// bf16 NCHW (n, cout, r, r); every width a multiple of 64 (zero channels
// pad the narrow ones); tab float32 (f, b) rows per conv in chain order, the
// projection last.  The launch is on the caller's stream, allocates nothing,
// and the C entry point returns the first CUDA error for the wrapper to check.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Form { BOT1 = 0, BAS1 = 1, BAS2 = 2, BOT2 = 3 };

constexpr int THREADS = 512;          // 16 warps, each up to 2 m-tiles x 32 channels
constexpr int NB = 6;                 // weight ring depth
constexpr int SLICE = 64 * 64;        // one weight slice: 64 outputs x 64 input channels
constexpr int SP = 200;               // bf16 staging pitch per channel (elements)
constexpr int SMEM_MAX = 232448;

// Tile geometry of each block form at TH output rows of TW = 14.
// Coordinates: (y0, x0) is the output tile's first pixel; OUT = TH * TW
// output pixels; the input region X holds XPIX pixels per 64-channel slab;
// T1 (bottleneck t1 or basic mid) holds C1ROWS pixels, one per row of the
// first conv.
//   BOT1  bottleneck, stride 1: X = t1 = the (TH+2) x 16 halo at (y0-1, x0-1)
//   BAS1  basic, stride 1: X = (TH+4) x 18 at (y0-2, x0-2), mid (TH+2) x 16
//         at (y0-1, x0-1)
//   BAS2  basic, stride 2: X = four (TH+3) x 17 phase planes of the
//         (2TH+5) x 33 input region at (2y0-3, 2x0-3); mid as BAS1
//   BOT2  bottleneck, stride 2 on the 3x3: X = t1 = four (TH+1) x 15 phase
//         planes of the (2TH+1) x 29 input region at (2y0-1, 2x0-1)
// At TH = 14 (7 for BOT2) these are the resident forms' 16 x 16, 18 x 18,
// 4 x 17 x 17 and 4 x 8 x 15 regions.
template <int FORM, int TH_>
struct Geo {
  static constexpr int TH = TH_, TW = 14, OUT = TH * TW;
  static constexpr int PW = FORM == BAS2 ? 17 : 15;           // phase-plane width
  static constexpr int PH = FORM == BAS2 ? TH + 3 : TH + 1;   // and height
  static constexpr int PP = PH * PW;
  static constexpr int RH = FORM == BAS2 ? 2 * TH + 4 : 2 * TH;   // last region row
  static constexpr int RW = FORM == BAS2 ? 32 : 28;               // and column
  static constexpr int XPIX =
      FORM == BOT1 ? (TH + 2) * 16 : FORM == BAS1 ? (TH + 4) * 18 : 4 * PP;
  static constexpr int C1ROWS = (FORM == BOT1 || FORM == BOT2) ? XPIX : (TH + 2) * 16;
  static_assert(C1ROWS % 16 == 0 && OUT <= SP, "tile geometry");
};

// input-region pixel p -> image coordinates (input side); false for the
// pad pixels of a phase plane
template <int FORM, int TH>
__device__ __forceinline__ bool x_pixel(int p, int y0, int x0, int& gy, int& gx) {
  using G = Geo<FORM, TH>;
  if (FORM == BOT1) {
    gy = y0 - 1 + p / 16, gx = x0 - 1 + p % 16;
  } else if (FORM == BAS1) {
    gy = y0 - 2 + p / 18, gx = x0 - 2 + p % 18;
  } else {
    const int pl = p / G::PP, pos = p % G::PP;
    const int ry = 2 * (pos / G::PW) + (pl >> 1), rx = 2 * (pos % G::PW) + (pl & 1);
    const int oy = FORM == BAS2 ? 2 * y0 - 3 : 2 * y0 - 1;
    const int ox = FORM == BAS2 ? 2 * x0 - 3 : 2 * x0 - 1;
    gy = oy + ry, gx = ox + rx;
    return ry <= G::RH && rx <= G::RW;
  }
  return true;
}
// a wide block's projection slab: output pixel m -> the input pixel its
// 1x1 (stride 1 or 2) reads
template <int FORM, int TH>
__device__ __forceinline__ void proj_pixel(int m, int y0, int x0, int& gy, int& gx) {
  constexpr int S = (FORM == BAS2 || FORM == BOT2) ? 2 : 1;
  gy = S * (y0 + m / 14), gx = S * (x0 + m % 14);
}

// first conv: GEMM row r -> source pixel in X, and tap t's offset
template <int FORM>
__device__ __forceinline__ int c1_px(int r) {
  if (FORM == BAS1) return (r / 16) * 18 + r % 16;
  if (FORM == BAS2) return (r / 16) * 17 + r % 16;
  return r;
}
template <int FORM, int TH>
__device__ __forceinline__ int c1_off(int t) {
  const int dy = t / 3, dx = t % 3;
  if (FORM == BAS1) return dy * 18 + dx;
  if (FORM == BAS2) return ((dy & 1) * 2 + (dx & 1)) * Geo<FORM, TH>::PP + (dy >> 1) * 17 + (dx >> 1);
  return 0;
}
// the 3x3 on T1 (bottleneck conv2, basic conv2): output pixel m -> source
// pixel in T1, and tap t's offset
template <int FORM>
__device__ __forceinline__ int c2_px(int m) {
  if (FORM == BOT2) return (m / 14) * 15 + m % 14;
  return (m / 14) * 16 + m % 14;
}
template <int FORM, int TH>
__device__ __forceinline__ int c2_off(int t) {
  const int dy = t / 3, dx = t % 3;
  if (FORM == BOT2) return ((dy & 1) * 2 + (dx & 1)) * Geo<FORM, TH>::PP + (dy >> 1) * 15 + (dx >> 1);
  return dy * 16 + dx;
}
// output pixel m -> the X pixel the projection and the identity residual
// read (resident forms)
template <int FORM, int TH>
__device__ __forceinline__ int res_px(int m) {
  constexpr int PP = Geo<FORM, TH>::PP;
  const int i = m / 14, j = m % 14;
  if (FORM == BOT1) return (i + 1) * 16 + j + 1;
  if (FORM == BAS1) return (i + 2) * 18 + j + 2;
  if (FORM == BAS2) return 3 * PP + (i + 1) * 17 + j + 1;
  return 3 * PP + i * 15 + j;
}
// T1 pixel r -> image coordinates (t1 at the input side, mid at the
// output side); false where the pixel is not in the image
template <int FORM, int TH>
__device__ __forceinline__ bool t1_inside(int r, int y0, int x0, int H, int R) {
  int gy, gx, side = H;
  bool ok = true;
  if (FORM == BOT1 || FORM == BOT2) {
    ok = x_pixel<FORM, TH>(r, y0, x0, gy, gx);
  } else {
    gy = y0 - 1 + r / 16, gx = x0 - 1 + r % 16, side = R;
  }
  return ok && gy >= 0 && gy < side && gx >= 0 && gx < side;
}

// shared-memory layout, in bytes (host and device).  Resident forms (xr =
// 0): X (all cin channels), T1 (bottleneck: the staging area after conv2),
// T2, RES, the basic staging area, the weight ring.  Wide forms: T1, T2,
// RES, staging, then X: xr slab slots of the input region during the first
// conv, and after it, in an entry block, the projection's input (the OUT
// pixels it reads at all cin channels), then the ring.
struct Lay {
  int x, t1, t2, res, stage, ring, bar, bytes;
};
template <int FORM, int TH>
__host__ __device__ Lay layout(int cin, int cmid, int cout, bool proj, bool last, int xr) {
  using G = Geo<FORM, TH>;
  constexpr bool BOT = FORM == BOT1 || FORM == BOT2;
  constexpr int OUT = G::OUT;
  const int stage = last ? 64 * SP * 2 : OUT * 64;
  Lay l;
  l.t1 = xr ? 0 : G::XPIX * cin;
  int t1b = G::C1ROWS * (BOT ? cmid : cout);
  if (BOT) {                       // staging takes t1's place once conv2 is done
    t1b = t1b > stage ? t1b : stage;
    l.stage = l.t1;
  }
  l.t2 = l.t1 + t1b;
  l.res = l.t2 + (BOT ? OUT * cmid : 0);
  int next = l.res + (proj ? OUT * 64 : 0);
  if (!BOT) {                      // the mid plane is read by every pass of conv2
    l.stage = next;
    next += stage;
  }
  l.x = xr ? next : 0;
  int xb = xr * G::XPIX * 64;
  if (xr && proj && OUT * cin > xb) xb = OUT * cin;
  next += xb;
  l.ring = next;
  l.bar = next + NB * SLICE;        // 2 NB mbarriers
  l.bytes = l.bar + 2 * NB * 8;
  return l;
}

// the slices a tile consumes, in the order _pack_stream packs them
template <int FORM, int TH>
__host__ __device__ int stream_slices(int cin, int cmid, int cout, bool proj) {
  const int cs = cin / 64, ms = cmid / 64, os = cout / 64;
  if (FORM == BOT1 || FORM == BOT2) {
    const int groups = (Geo<FORM, TH>::C1ROWS + 255) / 256;
    return groups * ms * cs + 9 * ms * ms + os * ((proj ? cs : 0) + ms);
  }
  return os * 9 * cs + os * ((proj ? cs : 0) + 9 * os);
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices: lanes 8j..8j+7 give the 16-byte rows of matrix j;
// for int8 register j of lane l is the m16n8k32 fragment word of row l/4
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared, zero-filled when !valid (0 bytes read)
__device__ __forceinline__ void cp_async16(unsigned char* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// mbarriers by shared-window address
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// one bulk copy global -> shared that completes on `bar` (the arrive and
// the byte count are posted first)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// byte offset of 16-byte chunk `chunk` (0-3) of 64-byte pixel row p
__device__ __forceinline__ int swz(int p, int chunk) {
  return (p << 6) | ((chunk ^ ((p >> 1) & 3)) << 4);
}

__device__ __forceinline__ int trunc_code(float v) {
  return (int)fminf(fmaxf(v, 0.f), 127.99f);
}

__device__ __forceinline__ float affine(int a, float f, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(a), f), b);
}

// The weight stream: slice j of the block's packed stream (j mod n) lands
// in slot j % NB by one bulk copy that thread 0 issues, completing on the
// slot's `full` mbarrier; each warp arrives on the slot's `empty` mbarrier
// once its ldmatrix loads of the slice are done, and the copy of slice j
// waits for slice j - NB's release.  NB - 1 slices are in flight, and only
// warp 0 (which issues) waits for the slowest warp; the others run ahead
// as far as the copies allow.  Every thread calls next() and release() for
// every slice, in stream order.
struct Ring {
  uint32_t buf;                    // shared address: NB slots, then NB full, NB empty bars
  const int8_t* w;
  int n, k, issued, used;          // k = issued mod n
  __device__ void issue() {
    if (threadIdx.x == 0) {
      const int slot = issued % NB;
      if (issued >= NB) mbar_wait(bars() + 8 * (NB + slot), (issued / NB - 1) & 1);
      bulk_load(buf + slot * SLICE, w + (size_t)k * SLICE, SLICE, bars() + 8 * slot);
    }
    if (++k == n) k = 0;
    ++issued;
  }
  __device__ uint32_t next() {
    issue();
    const int slot = used % NB;
    mbar_wait(bars() + 8 * slot, (used / NB) & 1);
    return buf + slot * SLICE;
  }
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(bars() + 8 * (NB + used % NB));
    ++used;
  }
  __device__ void drain() {        // no copy may land after the block exits
    for (int j = used; j < issued; ++j) mbar_wait(bars() + 8 * (j % NB), (j / NB) & 1);
  }
  __device__ uint32_t bars() const { return buf + NB * SLICE; }
};

// the MMAs of one weight slice: acc[mi] += rows px[mi] + o of the slab at
// a_src x this warp's 32 channels of the slice at wt
__device__ __forceinline__ void mma_slice(uint32_t a_src, uint32_t wt, const int px[2], int o,
                                          bool two, int a_chunk, int b_sw, int b_chunk,
                                          int acc[2][4][4]) {
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    uint32_t a[2][4];
    ldsm_x4(a[0], a_src + swz(px[0] + o, 2 * kh + a_chunk));
    if (two) ldsm_x4(a[1], a_src + swz(px[1] + o, 2 * kh + a_chunk));
    const int b_off = ((2 * kh + b_chunk) ^ b_sw) << 4;
#pragma unroll
    for (int np = 0; np < 2; ++np) {
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

__device__ __forceinline__ void zero_acc(int acc[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
}

// acc[mi] = this warp's m-tiles (source pixels px[mi], this lane's
// ldmatrix row) x its 32 channels (cb..cb+31) of the next taps * slabs
// slices of the stream.  Slab s of the source plane is at shared address
// src + s * slab_bytes; tap t adds off(t) pixels.  The barrier first: the
// pass may read a plane the previous epilogue wrote, and its epilogue may
// overwrite what the previous one's stores still read.
template <int TAPS, typename Off>
__device__ __forceinline__ void mma_pass(Ring& ring, const unsigned char* src_ptr, int slab_bytes,
                                         int slabs, const int px[2], bool one, bool two, int cb,
                                         int acc[2][4][4], Off off, int lane) {
  __syncthreads();
  const uint32_t src = smem_u32(src_ptr);
  zero_acc(acc);
  const int a_chunk = lane >> 4;
  const int b_row = cb + (lane & 7) + 8 * (lane >> 4);
  const int b_sw = (b_row >> 1) & 3, b_chunk = (lane >> 3) & 1;
#pragma unroll 1
  for (int t = 0; t < TAPS; ++t) {
    const int o = off(t);
#pragma unroll 1
    for (int s = 0; s < slabs; ++s) {
      const uint32_t wt = ring.next() + b_row * 64;
      if (one) mma_slice(src + s * slab_bytes, wt, px, o, two, a_chunk, b_sw, b_chunk, acc);
      ring.release();
    }
  }
}

// The same pass over a streamed source (the wide forms' input region):
// slabs outermost, each taken from the slab ring by
// x_next() (which waits for it and for every thread, then starts the next
// slab's copy), every tap of a slab before the next slab.
template <int TAPS, typename Off, typename XNext>
__device__ __forceinline__ void mma_pass_x(Ring& ring, XNext& x_next, int slabs, const int px[2],
                                           bool one, bool two, int cb, int acc[2][4][4], Off off,
                                           int lane) {
  __syncthreads();
  zero_acc(acc);
  const int a_chunk = lane >> 4;
  const int b_row = cb + (lane & 7) + 8 * (lane >> 4);
  const int b_sw = (b_row >> 1) & 3, b_chunk = (lane >> 3) & 1;
#pragma unroll 1
  for (int s = 0; s < slabs; ++s) {
    const uint32_t src = smem_u32(x_next());
#pragma unroll 1
    for (int t = 0; t < TAPS; ++t) {
      const uint32_t wt = ring.next() + b_row * 64;
      if (one) mma_slice(src, wt, px, off(t), two, a_chunk, b_sw, b_chunk, acc);
      ring.release();
    }
  }
}

template <int FORM, int TH, bool WIDE, bool PROJ, bool LAST>
__global__ void __launch_bounds__(THREADS, 1)
block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wst,
             const float* __restrict__ tab, float sx, void* __restrict__ out, int H, int R,
             int cin, int cmid, int cout, int tiles_y, int tiles_x, int total, int nslices,
             int nchw_c, int xr, int8_t* __restrict__ scratch) {
  using G = Geo<FORM, TH>;
  constexpr bool BOT = FORM == BOT1 || FORM == BOT2;
  constexpr int OUT = G::OUT;
  constexpr int XSLAB = G::XPIX * 64;
  constexpr int T1SLAB = G::C1ROWS * 64;
  constexpr int T2SLAB = OUT * 64;
  extern __shared__ __align__(128) unsigned char smem[];
  const Lay L = layout<FORM, TH>(cin, cmid, cout, PROJ, LAST, WIDE ? xr : 0);
  unsigned char* X = smem + L.x;
  unsigned char* T1 = smem + L.t1;
  unsigned char* T2 = smem + L.t2;
  unsigned char* RES = smem + L.res;
  unsigned char* STG = smem + L.stage;
  const uint32_t bars = smem_u32(smem + L.bar);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // warp (wr, wc): m-tiles wr and wr + 8 of a pass, channels cb..cb+31
  const int wr = warp & 7, cb = 32 * (warp >> 3);
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int cs = cin / 64, ms = cmid / 64, os = cout / 64;
  // tables: (f, b) per conv in chain order, the projection last (offsets
  // from the kernel's parameters, so no register holds them)
#define W1 (BOT ? cmid : cout)
#define F3 (BOT ? 4 * cmid : 2 * cout)

  if (tid == 0) {
    for (int i = 0; i < NB; ++i) {
      mbar_init(bars + 8 * i, 1);                  // the issuing thread's arrive
      mbar_init(bars + 8 * (NB + i), THREADS / 32);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring ring{smem_u32(smem + L.ring), wst, nslices, 0, 0, 0};
  for (int i = 0; i < NB - 1; ++i) ring.issue();

  // Pixels p of 64-channel slab s of the input into dst (channel-last,
  // swizzled), zero outside the image (the convs' zero padding): the input
  // region of tile tl (pj false) or, for a wide block's projection, the
  // input pixel of each of its OUT output pixels (pj true): from a stage's
  // int8 NCHW codes (nchw_c channels, the rest zero) slab by slab,
  // load_nchw_slab; from an NHWC plane 16 bytes per cp.async, as one
  // group.
  auto pixel = [&](bool pj, int p, int y0, int x0, int& gy, int& gx) {
    if (WIDE && pj) {
      proj_pixel<FORM, TH>(p, y0, x0, gy, gx);
      return gy < H && gx < H;
    }
    return x_pixel<FORM, TH>(p, y0, x0, gy, gx) && gy >= 0 && gy < H && gx >= 0 && gx < H;
  };
  // one slab from NCHW codes: one item per 16 channels of a pixel
  // (neighbouring threads on neighbouring pixels, so each of the 16 byte
  // loads is coalesced across the warp), the index arithmetic once per item
  // and its 16 loads in flight together, one 16-byte shared store (and, for
  // a wide form's first pass, one into its kept image)
  auto load_nchw_slab = [&](unsigned char* dst, int tl, int s, bool pj, int8_t* keep) {
    const int img = tl / (tiles_y * tiles_x), t = tl % (tiles_y * tiles_x);
    const int y0 = (t / tiles_x) * G::TH, x0 = (t % tiles_x) * G::TW;
    const int hh = H * H;
    const int8_t* xs = x + (img * nchw_c + 64 * s) * hh;
    const int npix = pj ? OUT : G::XPIX;
#pragma unroll 1
    for (int i = tid; i < 4 * npix; i += THREADS) {
      const int q = i / npix, p = i - q * npix, c0 = 64 * s + 16 * q;
      int gy, gx;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (c0 < nchw_c && pixel(pj, p, y0, x0, gy, gx)) {
        const int8_t* src = xs + 16 * q * hh + gy * H + gx;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (c0 + k < nchw_c)
            w[k >> 2] |= (uint32_t)(uint8_t)__ldg(src + k * hh) << (8 * (k & 3));
      }
      const uint4 v = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + swz(p, q)) = v;
      if (keep) *reinterpret_cast<uint4*>(keep + swz(p, q)) = v;
    }
  };
  // a slab image this block kept in its scratch, back by cp.async
  auto load_kept = [&](unsigned char* dst, const int8_t* src) {
#pragma unroll 1
    for (int i = tid; i < XSLAB / 16; i += THREADS) cp_async16(dst + 16 * i, src + 16 * i, true);
    cp_async_commit();
  };
  auto load_nhwc = [&](unsigned char* dst, int tl, int s0, int s1, bool pj) {
    const int img = tl / (tiles_y * tiles_x), t = tl % (tiles_y * tiles_x);
    const int y0 = (t / tiles_x) * G::TH, x0 = (t % tiles_x) * G::TW;
    const int8_t* xn = x + img * H * H * cin;
    const int npix = pj ? OUT : G::XPIX;
#pragma unroll 1
    for (int i = tid; i < (s1 - s0) * npix * 4; i += THREADS) {
      const int s = i / (npix * 4), p = (i >> 2) % npix, q = i & 3;
      int gy, gx;
      const bool ok = pixel(pj, p, y0, x0, gy, gx);
      cp_async16(dst + s * (pj ? OUT * 64 : XSLAB) + swz(p, q),
                 ok ? xn + (gy * H + gx) * cin + (s0 + s) * 64 + q * 16 : x, ok);
    }
    cp_async_commit();
  };

  // The wide forms' slab ring.  A tile's X stream is nsteps slabs: the
  // first conv's passes (per 256-row group of a bottleneck and per 64
  // outputs, every input slab).  Step j of the block's stream (tile
  // blockIdx.x + (j / nsteps) * gridDim.x) lands in slot j % xr: with two
  // slots the next step's copy starts as soon as every thread is past the
  // previous one, across passes and, in an identity block, across tiles (an
  // entry block's projection input takes the slots' place until its tile
  // ends, so its next tile's first slab is copied at that tile's start).
  // From NCHW codes a tile's first pass (its first cs steps) gathers each
  // slab and keeps the slab's image in this block's part of `scratch`; the
  // later passes copy the image back (its writes are ordered before those
  // reads by the barriers between the passes).
  const int nsteps = BOT ? (G::C1ROWS + 255) / 256 * ms * cs : os * cs;
  int xj = 0;
  auto x_load = [&](int j) {
    const int tl = blockIdx.x + (j / nsteps) * gridDim.x, s = j % nsteps % cs;
    if (tl >= total) return;
    unsigned char* dst = X + (j % xr) * XSLAB;
    if (nchw_c) {
      int8_t* kept = scratch + ((size_t)blockIdx.x * cs + s) * XSLAB;
      if (j % nsteps < cs)
        load_nchw_slab(dst, tl, s, false, kept);
      else
        load_kept(dst, kept);
    } else {
      load_nhwc(dst, tl, s, s + 1, false);
    }
  };
  auto x_next = [&]() -> const unsigned char* {
    if (xr == 1) {
      __syncthreads();             // every thread is done with the slot
      x_load(xj);
    }
    cp_async_wait_all();
    __syncthreads();
    if (xr == 2 && (!PROJ || (xj + 1) % nsteps)) x_load(xj + 1);
    return X + (xj++ % xr) * XSLAB;
  };

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int img = tile / (tiles_y * tiles_x);
    const int t = tile % (tiles_y * tiles_x);
    const int y0 = (t / tiles_x) * G::TH, x0 = (t % tiles_x) * G::TW;
    const bool has_next = tile + gridDim.x < total;

    __syncthreads();          // the previous tile is done with X and the staging area
    if (WIDE && xr == 2 && (PROJ || tile == (int)blockIdx.x)) x_load(xj);
    if constexpr (!WIDE) {
      // an identity block reading NHWC had its previous tile prefetch this
      // one's input region
      if (nchw_c)
        for (int s = 0; s < cs; ++s) load_nchw_slab(X + s * XSLAB, tile, s, false, nullptr);
      else if (PROJ || tile == (int)blockIdx.x)
        load_nhwc(X, tile, 0, cs, false);
      cp_async_wait_all();
      __syncthreads();
    }

    int acc[2][4][4];
    int px[2];

    // int8 plane epilogue (t1, t2, mid): pass rows g0.. -> pixel row of
    // slab n of dst; zero where the pixel is outside the image (zero_out)
    auto epi_plane = [&](unsigned char* dst, int slab_bytes, int n, int g0, int rows,
                         const float* f, const float* b, bool zero_out) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = cb + 8 * ni + 2 * t4, co = 64 * n + o;
        const float fa = __ldg(f + co), fb = __ldg(f + co + 1);
        const float ba = __ldg(b + co), bb = __ldg(b + co + 1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = g0 + (wr + 8 * mi) * 16 + g + 8 * h;
            if (r >= rows) continue;
            uint32_t pair = 0;
            if (!zero_out || t1_inside<FORM, TH>(r, y0, x0, H, R))
              pair = (uint32_t)trunc_code(affine(acc[mi][ni][2 * h], fa, ba)) |
                     (uint32_t)trunc_code(affine(acc[mi][ni][2 * h + 1], fb, bb)) << 8;
            *reinterpret_cast<uint16_t*>(dst + n * slab_bytes + swz(r, o >> 4) + (o & 15)) =
                (uint16_t)pair;
          }
        }
        asm volatile("" ::: "memory");   // one channel group's loads at a time
      }
    };
    // the identity residual of output pixel m, channels c, c + 1, read
    // from the block's input in device memory (wide forms; L2-hot: the tile
    // just read its region)
    auto res_global = [&](int m, int c) -> uint32_t {
      const int oy = y0 + m / G::TW, ox = x0 + m % G::TW;
      if (oy >= R || ox >= R) return 0;
      if (nchw_c) {
        const int8_t* p = x + ((img * nchw_c + c) * H + oy) * H + ox;
        return (c < nchw_c ? (uint32_t)(uint8_t)__ldg(p) : 0u) |
               (c + 1 < nchw_c ? (uint32_t)(uint8_t)__ldg(p + H * H) : 0u) << 8;
      }
      return __ldg(reinterpret_cast<const unsigned short*>(x + ((img * H + oy) * H + ox) * cin + c));
    };
    // the block's sum for output channels 64n..64n+63, staged, then stored
    auto epi_final = [&](int n) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = cb + 8 * ni + 2 * t4, co = 64 * n + o;
        const float fa = __ldg(tab + F3 + co), fb = __ldg(tab + F3 + co + 1);
        const float ba = __ldg(tab + F3 + cout + co), bb = __ldg(tab + F3 + cout + co + 1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (wr + 8 * mi) * 16 + g + 8 * h;
            if (m >= OUT) continue;
            uint32_t res;
            if (PROJ)
              res = *reinterpret_cast<const uint16_t*>(RES + swz(m, o >> 4) + (o & 15));
            else if (WIDE)
              res = res_global(m, co);
            else
              res = *reinterpret_cast<const uint16_t*>(X + n * XSLAB +
                                                      swz(res_px<FORM, TH>(m), o >> 4) + (o & 15));
            float y[2];
            y[0] = __fadd_rn(affine(acc[mi][ni][2 * h], fa, ba),
                             __fmul_rn(__int2float_rn((int)(int8_t)(res & 0xff)), sx));
            y[1] = __fadd_rn(affine(acc[mi][ni][2 * h + 1], fb, bb),
                             __fmul_rn(__int2float_rn((int)(int8_t)(res >> 8)), sx));
            if (LAST) {
              uint16_t* s16 = reinterpret_cast<uint16_t*>(STG);
#pragma unroll
              for (int e = 0; e < 2; ++e)
                s16[(o + e) * SP + m] = __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(y[e], 0.f)));
            } else {
              *reinterpret_cast<uint16_t*>(STG + swz(m, o >> 4) + (o & 15)) =
                  (uint16_t)((uint32_t)trunc_code(y[0]) | (uint32_t)trunc_code(y[1]) << 8);
            }
          }
        }
        asm volatile("" ::: "memory");
      }
      __syncthreads();
      // an identity block is done with slab n of X: the next tile's streams in
      if (!WIDE && !PROJ && !nchw_c && has_next)
        load_nhwc(X + n * XSLAB, tile + gridDim.x, n, n + 1, false);
      if (LAST) {
        // NCHW rows: pixel pairs (TW, R and x0 even: a pair stays in its row)
        __nv_bfloat16* o16 = reinterpret_cast<__nv_bfloat16*>(out);
#pragma unroll 1
        for (int i = tid; i < 64 * (OUT / 2); i += THREADS) {
          const int c = i / (OUT / 2), m = 2 * (i % (OUT / 2));
          const int oy = y0 + m / G::TW, ox = x0 + m % G::TW;
          if (oy >= R || ox >= R) continue;
          *reinterpret_cast<uint32_t*>(o16 + ((img * cout + 64 * n + c) * R + oy) * R + ox) =
              *reinterpret_cast<const uint32_t*>(reinterpret_cast<const uint16_t*>(STG) + c * SP + m);
        }
      } else {
        int8_t* o8 = reinterpret_cast<int8_t*>(out);
#pragma unroll 1
        for (int i = tid; i < OUT * 4; i += THREADS) {
          const int m = i >> 2, q = i & 3;
          const int oy = y0 + m / G::TW, ox = x0 + m % G::TW;
          if (oy >= R || ox >= R) continue;
          *reinterpret_cast<uint4*>(o8 + ((img * R + oy) * R + ox) * cout + 64 * n + 16 * q) =
              *reinterpret_cast<const uint4*>(STG + swz(m, q));
        }
      }
    };
    // a wide entry block, once its first conv is through the slab slots:
    // the projection's input (each output pixel's input pixel, every slab)
    // into X, slab s at s * OUT * 64 (waited for by the first projection)
    auto load_proj = [&]() {
      __syncthreads();        // every thread is done with the slab slots
      if (nchw_c) {
        for (int s = 0; s < cs; ++s) load_nchw_slab(X + s * OUT * 64, tile, s, true, nullptr);
      } else {
        load_nhwc(X, tile, 0, cs, true);
      }
    };
    // the projection of output channels 64n..64n+63 into RES
    auto projection = [&](int n) {
      const int mt = (OUT + 15) / 16;
      if constexpr (WIDE) {
        if (n == 0) cp_async_wait_all();
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) px[mi] = min((wr + 8 * mi) * 16 + lrow, OUT - 1);
        mma_pass<1>(ring, X, OUT * 64, cs, px, wr < mt, wr + 8 < mt, cb, acc,
                    [](int) { return 0; }, lane);
      } else {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          px[mi] = res_px<FORM, TH>(min((wr + 8 * mi) * 16 + lrow, OUT - 1));
        mma_pass<1>(ring, X, XSLAB, cs, px, wr < mt, wr + 8 < mt, cb, acc, [](int) { return 0; },
                    lane);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = cb + 8 * ni + 2 * t4, co = 64 * n + o;
        const float fa = __ldg(tab + F3 + 2 * cout + co), fb = __ldg(tab + F3 + 2 * cout + co + 1);
        const float ba = __ldg(tab + F3 + 3 * cout + co), bb = __ldg(tab + F3 + 3 * cout + co + 1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (wr + 8 * mi) * 16 + g + 8 * h;
            if (m >= OUT) continue;
            const int va = (int)fminf(fmaxf(floorf(affine(acc[mi][ni][2 * h], fa, ba)), -127.f), 127.f);
            const int vb = (int)fminf(fmaxf(floorf(affine(acc[mi][ni][2 * h + 1], fb, bb)), -127.f), 127.f);
            *reinterpret_cast<uint16_t*>(RES + swz(m, o >> 4) + (o & 15)) =
                (uint16_t)(((uint32_t)va & 0xff) | ((uint32_t)vb & 0xff) << 8);
          }
        }
        asm volatile("" ::: "memory");
      }
    };

    const int mt_out = (OUT + 15) / 16;
    if constexpr (BOT) {
      // conv1 (1x1) over every t1 pixel, in groups of 16 m-tiles
      for (int g0 = 0; g0 < G::C1ROWS; g0 += 256) {
        const int mt = min(16, (G::C1ROWS - g0) / 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          px[mi] = min(g0 + (wr + 8 * mi) * 16 + lrow, G::C1ROWS - 1);
        for (int n = 0; n < ms; ++n) {
          if constexpr (WIDE)
            mma_pass_x<1>(ring, x_next, cs, px, wr < mt, wr + 8 < mt, cb, acc,
                          [](int) { return 0; }, lane);
          else
            mma_pass<1>(ring, X, XSLAB, cs, px, wr < mt, wr + 8 < mt, cb, acc,
                        [](int) { return 0; }, lane);
          epi_plane(T1, T1SLAB, n, g0, G::C1ROWS, tab, tab + W1, true);
        }
      }
      if (WIDE && PROJ) load_proj();
      // conv2 (3x3, stride 1 or 2 by the phase layout) over the output tile
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) px[mi] = c2_px<FORM>(min((wr + 8 * mi) * 16 + lrow, OUT - 1));
      for (int n = 0; n < ms; ++n) {
        mma_pass<9>(ring, T1, T1SLAB, ms, px, wr < mt_out, wr + 8 < mt_out, cb, acc,
                    [](int t) { return c2_off<FORM, TH>(t); }, lane);
        epi_plane(T2, T2SLAB, n, 0, OUT, tab + 2 * W1, tab + 3 * W1, false);
      }
      // conv3 (1x1) in passes of 64 output channels, each after its projection
      for (int n = 0; n < os; ++n) {
        if (PROJ) projection(n);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) px[mi] = min((wr + 8 * mi) * 16 + lrow, OUT - 1);
        mma_pass<1>(ring, T2, T2SLAB, ms, px, wr < mt_out, wr + 8 < mt_out, cb, acc,
                    [](int) { return 0; }, lane);
        epi_final(n);
      }
    } else {
      // conv1 (3x3, stride 1 or 2 by the phase layout) over the mid halo
      constexpr int mt1 = G::C1ROWS / 16;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        px[mi] = c1_px<FORM>(min((wr + 8 * mi) * 16 + lrow, G::C1ROWS - 1));
      for (int n = 0; n < os; ++n) {
        if constexpr (WIDE)
          mma_pass_x<9>(ring, x_next, cs, px, wr < mt1, wr + 8 < mt1, cb, acc,
                        [](int t) { return c1_off<FORM, TH>(t); }, lane);
        else
          mma_pass<9>(ring, X, XSLAB, cs, px, wr < mt1, wr + 8 < mt1, cb, acc,
                      [](int t) { return c1_off<FORM, TH>(t); }, lane);
        epi_plane(T1, T1SLAB, n, 0, G::C1ROWS, tab, tab + W1, true);
      }
      if (WIDE && PROJ) load_proj();
      // conv2 (3x3) over the output tile, each pass after its projection
      for (int n = 0; n < os; ++n) {
        if (PROJ) projection(n);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) px[mi] = c2_px<FORM>(min((wr + 8 * mi) * 16 + lrow, OUT - 1));
        mma_pass<9>(ring, T1, T1SLAB, os, px, wr < mt_out, wr + 8 < mt_out, cb, acc,
                    [](int t) { return c2_off<FORM, TH>(t); }, lane);
        epi_final(n);
      }
    }
  }
  cp_async_wait_all();
  ring.drain();
#undef W1
#undef F3
}

// ------------------------------------------------------------------ host
struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* tab;
  float sx;
  void* out;
  int n, h, cin, cmid, cout, nslices, nchw_c, xr;
  int8_t* scratch;
  long long scratch_bytes;
  cudaStream_t s;
};

template <int FORM, int TH, bool WIDE, bool PROJ, bool LAST>
int launch(const Args& a) {
  using G = Geo<FORM, TH>;
  const int h = a.h, cin = a.cin, cmid = a.cmid, cout = a.cout;
  const Lay L = layout<FORM, TH>(cin, cmid, cout, PROJ, LAST, a.xr);
  if (L.bytes > SMEM_MAX || a.nslices != stream_slices<FORM, TH>(cin, cmid, cout, PROJ))
    return (int)cudaErrorInvalidValue;
  const int r = (FORM == BAS2 || FORM == BOT2) ? h / 2 : h;
  const int ty = (r + G::TH - 1) / G::TH, tx = (r + G::TW - 1) / G::TW;
  const long long total = (long long)a.n * ty * tx;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = block_kernel<FORM, TH, WIDE, PROJ, LAST>;
  static bool sized = false;   // the shared-memory opt-in, once per instantiation
  cudaError_t e;
  if (!sized) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)) !=
        cudaSuccess)
      return (int)e;
    sized = true;
  }
  // one block per SM: 512 threads at up to 128 registers fill its register file
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
  }
  const int grid = total < sms ? (int)total : sms;
  // a wide form on NCHW codes keeps each block's slab images: grid x cin
  // x the input region's pixels (stagen._launch_block allocates it)
  if (WIDE && a.nchw_c &&
      (a.scratch == nullptr || a.scratch_bytes < (long long)grid * (cin / 64) * G::XPIX * 64 ||
       ((uintptr_t)a.scratch & 15)))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, THREADS, L.bytes, a.s>>>(a.x, a.w, a.tab, a.sx, a.out, h, r, cin, cmid, cout, ty,
                                          tx, (int)total, a.nslices, a.nchw_c, a.xr, a.scratch);
  return (int)cudaGetLastError();
}

template <int FORM, int TH, bool WIDE, bool PROJ>
int launch_last(int last, const Args& a) {
  return last ? launch<FORM, TH, WIDE, PROJ, true>(a) : launch<FORM, TH, WIDE, PROJ, false>(a);
}

// the stride-1 forms take either projection; the stride-2 forms have one
template <int FORM, int TH, bool WIDE>
int launch_geo(int proj, int last, const Args& a) {
  if constexpr (FORM == BAS2 || FORM == BOT2)
    return launch_last<FORM, TH, WIDE, true>(last, a);
  else
    return proj ? launch_last<FORM, TH, WIDE, true>(last, a)
                : launch_last<FORM, TH, WIDE, false>(last, a);
}

// The geometries (form, tile rows, streamed input) the library holds: the
// resident forms, and the wide forms at the tile heights their widest
// ResNet blocks need (stagen._GEOMETRIES lists the same).
template <typename F>
int by_geometry(int form, int th, int xr, F f) {
  const bool wide = xr > 0;
  switch (form) {
    case BOT1:
      if (th == 14) return wide ? f.template go<BOT1, 14, true>() : f.template go<BOT1, 14, false>();
      if (th == 7 && wide) return f.template go<BOT1, 7, true>();
      break;
    case BAS1:
      if (th == 14) return wide ? f.template go<BAS1, 14, true>() : f.template go<BAS1, 14, false>();
      break;
    case BAS2:
      if (th == 14) return wide ? f.template go<BAS2, 14, true>() : f.template go<BAS2, 14, false>();
      if (th == 7 && wide) return f.template go<BAS2, 7, true>();
      break;
    case BOT2:
      if (th == 7) return wide ? f.template go<BOT2, 7, true>() : f.template go<BOT2, 7, false>();
      if (th == 3 && wide) return f.template go<BOT2, 3, true>();
      break;
  }
  return -1;
}

struct Launch {
  const Args& a;
  int proj, last;
  template <int FORM, int TH, bool WIDE>
  int go() const { return launch_geo<FORM, TH, WIDE>(proj, last, a); }
};

struct Smem {
  int cin, cmid, cout, proj, last, xr;
  template <int FORM, int TH, bool WIDE>
  int go() const { return layout<FORM, TH>(cin, cmid, cout, proj, last, xr).bytes; }
};

}  // namespace

// One residual block: x (n, h, h, cin) int8 NHWC, or, when nchw_c > 0, the
// stage's int8 codes (n, nchw_c, h, h) NCHW with nchw_c <= cin -> (n, r, r,
// cout) int8 NHWC, or (n, cout, r, r) bf16 NCHW when `last`.  form: 0
// bottleneck stride 1, 1 basic stride 1, 2 basic stride 2, 3 bottleneck
// stride 2 (r = h / 2; both stride-2 forms have a projection); th the tile
// rows and xr the input's slab slots (0: resident), a geometry the library
// holds (by_geometry); cmid = cout for a basic block; w the block's packed
// weight stream of `nslices` 4 KB slices; tab the folded (f, b) rows;
// scratch (scratch_bytes) the wide forms' slab images when they read NCHW
// codes: min(tiles, SMs) x cin x the region's pixels, 16-byte aligned.
// Widths are multiples of 64, r is even, and every plane's element count
// fits in an int.
extern "C" int stagen_block(const void* x, const void* w, const void* tab, float sx, void* out,
                            int n, int h, int cin, int cmid, int cout, int form, int th, int xr,
                            int proj, int last, int nslices, int nchw_c, void* scratch,
                            long long scratch_bytes, void* stream) {
  if (n <= 0 || h <= 0 || cin <= 0 || cmid <= 0 || cout <= 0 || cin % 64 || cmid % 64 ||
      cout % 64 || nchw_c < 0 || nchw_c > cin || xr < 0 || xr > 2)
    return (int)cudaErrorInvalidValue;
  const bool s2 = form == BAS2 || form == BOT2;
  if ((s2 && (h % 4 || !proj)) || (!s2 && h % 2) || (!proj && cin != cout))
    return (int)cudaErrorInvalidValue;
  const long long side = h, big = cin > cout ? cin : cout;
  if ((long long)n * side * side * big > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
  const Args a{reinterpret_cast<const int8_t*>(x), reinterpret_cast<const int8_t*>(w),
               reinterpret_cast<const float*>(tab), sx, out, n, h, cin, cmid, cout, nslices,
               nchw_c, xr, reinterpret_cast<int8_t*>(scratch), scratch_bytes,
               reinterpret_cast<cudaStream_t>(stream)};
  const int e = by_geometry(form, th, xr, Launch{a, proj, last});
  return e < 0 ? (int)cudaErrorInvalidValue : e;
}

// Dynamic shared memory in bytes that stagen_block needs for a block of this
// form, geometry (th, xr) and these (64-padded) widths, or -1 for a
// geometry the library does not hold; a geometry is usable where it is at
// most 232448 (227 KB).
extern "C" int stagen_block_smem(int form, int th, int xr, int cin, int cmid, int cout, int proj,
                                 int last) {
  if (xr < 0 || xr > 2) return -1;
  return by_geometry(form, th, xr, Smem{cin, cmid, cout, proj, last, xr});
}
