// int8 convolutions of the fused-int8 YOLOv3 for Hopper (sm_90a): the
// downsample cell K3 and the direct int8 conv cell, one template.
//
// K3 ports the TPU kernel videoyolo_tpu/ops/pallas_conv.py:
// int8_s2d_downsample_conv (body _kernel :87-108, wrapper
// pallas_quant_downsample :214): the 3x3 / stride-2 / pad-1 conv of a
// fused-int8 cell, int32 accumulation, then
//   y = acc * scale + bias, leaky 0.1, round(y * (1/oscale)) clipped to +-127.
// The direct cell replaces XLA's int8 conv_general_dilated of
// videoyolo_tpu/models/layers.py:quant_conv_cell (:228-247), which the JAX
// package emits outside any Pallas kernel: 1x1 and 3x3 convs of any stride,
// pad k/2, with one of four epilogues: requantise to int8 by y / oscale (the
// cells that emit a QTensor), leaky in float32 or bf16 (the tips), or the raw
// int32 sums (the calibration pass).  Plain PyTorch versions:
// videoyolo_torch/ops/int8_conv.py:quant_downsample_plain and
// int8_conv_plain; Python wrappers and the plan that picks route and tile:
// videoyolo_torch/ops/int8_conv_kernel.py.
//
// The s2d fold, the packed tap matrices and the two stacked halo views of the
// TPU kernel exist only because of Mosaic's limits; none is carried over.
// Both kernels read the NHWC int8 input as it lies (an NCHW tensor in
// channels_last memory) and the (F, KH, KW, C) weights (an OIHW tensor in
// channels_last memory), and write NHWC.
//
// Bit equality.  acc * scale + bias is ONE rounding (fmaf): under jit the JAX
// package's XLA contracts that multiply-add into an FMA, in the direct cells
// and in the Pallas kernel alike.  The leaky multiply, the division of the
// direct cells and the reciprocal multiply of K3 are IEEE round-to-nearest
// (the reciprocal by __frcp_rn, as 1.0f / oscale); rint rounds half to even.
// The file builds with -fmad=false, so no other multiply-add is contracted.
// The sums are int32 and exact in any order, so no tiling changes a bit.
//
// Design: an implicit GEMM.  M = the B*Ho*Wo output pixels, N = the F output
// channels, K = KH*KW*C, taken tap by tap (k = (r*KW + s)*C + c).  A CTA
// takes a 128-pixel x BN-channel output tile, BN = 32 for F <= 32, 64 for F
// <= 64, else 128 (64 at most off the wgmma route).  K advances BK bytes a
// stage through a ring of shared memory filled by cp.async: for each output
// pixel of the tile, the BK input bytes that the current taps reach,
// zero-filled outside the image, and the matching BK bytes of each weight
// row.  The route and tile are chosen by shape on the host
// (int8_conv_kernel.plan) and checked here: an entry point refuses a
// combination it was not built for.
//
// - wgmma (C % 16 == 0: K3's cells and every direct cell but the stem).  On
//   an H100 the 3x3 cells are bound by int8 operations and the 1x1 cells
//   and the 416-px downsample by bytes; only wgmma reaches the tensor cores'
//   full rate, and it reads both operands from shared memory, so no
//   fragment passes through registers.  Two consumer warpgroups (256
//   threads) each take 64 pixels x BN channels with wgmma.mma_async
//   m64nBNk32 s8, int32 accumulators in registers.  Every thread also
//   copies: 16-byte cp.async segments (each inside one tap) written straight
//   into wgmma's K-major swizzled layout, two stages ahead of the stage
//   multiplied, with one wgmma group in flight behind it.  BK = 64 with the
//   64-byte swizzle, 4 stages; for deep K (int8_conv_kernel.DEEP_K) BK = 128 with the
//   128-byte swizzle, 3 stages, half the barriers per product.  Each stage
//   is made visible to the async proxy (fence.proxy.async) before the
//   barrier that hands it to wgmma, and a slot is refilled only after the
//   group that read it has retired.  What bounds it now: every thread
//   waits at a CTA barrier each stage, and each CTA loads, multiplies and
//   stores one tile with nothing to overlap its first loads and its
//   epilogue (on an H100 the cells ran at 4-5x their bound).  The no-swizzle
//   layout of 8-row x 16-byte core matrices starved the tensor cores: 1.3-
//   1.6x slower.
// - mma_word (C % 4 == 0: the 4-channel stem) and mma_byte (any C).  The
//   stem is bound by bytes: 22M output pixels of 36 input bytes and 32
//   channels each, one K stage a CTA, so its CTAs' load latency and
//   epilogue arithmetic set its pace (about 9x its bound).  Four warps of
//   mma.sync.m16n8k32 s8 over a 3-stage ring of rows padded to 80 bytes
//   (fragment loads on 32 banks), copied 4 bytes at a time with cp.async
//   stepping through the taps, or gathered byte by byte.
//
// Every route stages its epilogue: each thread computes its outputs in
// registers (each channel's scale and bias loaded once) and writes them,
// typed, into the ring, which the main loop no longer needs; then the CTA
// copies its tile to global memory row by row, 16 bytes a thread.  When the
// tile spans all of F, its output is one contiguous block.
//
// What is left for later: TMA (its im2col mode) in place of the cp.async
// loader, a producer warp with setmaxnreg and mbarriers in place of the CTA
// barrier, persistent CTAs that overlap one tile's epilogue with the next
// one's loads, and one halo tile per CTA reused across the taps (the input
// is now re-read per tap, from L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;  // output pixels per CTA
constexpr int kBK = 64;   // bytes of K per stage of the mma.sync routes

// routes (keep in step with ops/int8_conv_kernel.py)
constexpr int kRouteByte = 0;   // any C: bytes gathered by the threads, mma.sync
constexpr int kRouteWord = 1;   // C % 4 == 0: 4-byte cp.async, mma.sync
constexpr int kRouteWgmma = 2;  // C % 16 == 0: 16-byte cp.async, wgmma

// the mma.sync routes: four warps, a 3-stage ring of rows padded to 80 bytes
constexpr int kMmaThreads = 128;
constexpr int kMmaStages = 3;
constexpr int kRow = kBK + 16;  // padded shared-memory row: 16-byte aligned, no bank conflicts
// the wgmma route: two warpgroups; stages of BK = 64 bytes of K in a 4-stage
// ring, or of 128 bytes in a 3-stage ring (two CTAs an SM)
constexpr int kWgThreads = 256;

__host__ __device__ constexpr int threads_of(int route) {
  return route == kRouteWgmma ? kWgThreads : kMmaThreads;
}
__host__ __device__ constexpr int stages_of(int route, int bk) {
  return route != kRouteWgmma ? kMmaStages : bk == 128 ? 3 : 4;
}
__host__ __device__ constexpr int ring_bytes(int route, int bn, int bk) {
  return route == kRouteWgmma ? stages_of(route, bk) * (kBM + bn) * bk : kMmaStages * (kBM + bn) * kRow;
}
// shared memory of a CTA: the ring, or the staged output tile of the widest
// type (int32) with room for each row's 16-byte offset, whichever is larger
__host__ __device__ constexpr int stage_stride(int bn, int ob) { return bn * ob + 16; }
__host__ __device__ constexpr int smem_bytes(int route, int bn, int bk) {
  return ring_bytes(route, bn, bk) > kBM * stage_stride(bn, 4) ? ring_bytes(route, bn, bk)
                                                               : kBM * stage_stride(bn, 4);
}

// epilogues
constexpr int kRaw = 0;        // int32 sums
constexpr int kRealF32 = 1;    // leaky(fma(acc, scale, bias)) as float32
constexpr int kRealBF16 = 2;   // ... as bf16
constexpr int kQuantDiv = 3;   // int8: rint(y / oscale) clipped (the direct cells)
constexpr int kQuantRcp = 4;   // int8: rint(y * (1 / oscale)) clipped (K3)

template <int kEpi>
using OutT = typename std::conditional<
    kEpi == kRaw, int,
    typename std::conditional<kEpi == kRealF32, float,
                              typename std::conditional<kEpi == kRealBF16, __nv_bfloat16,
                                                        int8_t>::type>::type>::type;

struct ConvParams {
  const int8_t* x;      // (B, H, W, C)
  const int8_t* w;      // (F, KH, KW, C)
  const float* scale;   // (F,)
  const float* bias;    // (F,)
  const float* oscale;  // scalar
  void* out;            // (B, Ho, Wo, F)
  int B, H, W, C, F, KH, KW, stride, pad, Ho, Wo, K, M;
  int n_tiles;          // output-channel tiles
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// wgmma: a 64 x N x 32 product of the warpgroup, A and B K-major in shared
// memory, int32 sums added to d (scale-d 1).  The accumulator layout is
// mma.sync's C layout per 16 rows: warp w of the warpgroup holds rows 16w + g
// and 16w + g + 8, d[4i + 2h + e] at row 16w + g + 8h, column 8i + 2t + e.
template <int kN>
__device__ __forceinline__ void wgmma_s8(int (&d)[kN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
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
// the generic proxy's writes to shared memory (cp.async) made visible to the
// async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products' issue and wait
template <int kN>
__device__ __forceinline__ void fence_accumulators(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The descriptor of a K-major operand in the kBK-byte swizzle layout: rows of
// kBK bytes of K, whose 16-byte chunk j lies at chunk j ^ (row * kBK / 128 %
// (kBK / 16)) (address bits 4-6 XORed with bits 7-9, so a stage starts on
// 1024 bytes), 8-row groups 8 * kBK bytes apart.  p may point 32 j bytes into
// a row, at its k32 slice j; the leading byte offset is unused.
template <int kBK>
__device__ __forceinline__ uint64_t smem_desc(const int8_t* p) {
  constexpr uint64_t kLayout = kBK == 128 ? 1 : 2;  // the 128- or 64-byte swizzle
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3ffff) >> 4) | (1ull << 16) | (static_cast<uint64_t>(8 * kBK >> 4) << 32) |
         (kLayout << 62);
}

// The input pixel that output pixel m reads at tap offset (0, 0), or img -1
// past the last pixel.
struct PixelRow {
  int img, iy, ix;
  __device__ void init(const ConvParams& p, int m) {
    if (m >= p.M) {
      img = -1;
      iy = ix = 0;
      return;
    }
    const int hw = p.Ho * p.Wo;
    img = m / hw;
    const int rem = m - img * hw;
    const int oy = rem / p.Wo;
    iy = oy * p.stride - p.pad;
    ix = (rem - oy * p.Wo) * p.stride - p.pad;
  }
  // the input byte offset of channel c at tap (r, s), or -1 outside the image
  __device__ long long offset(const ConvParams& p, int r, int s, int c) const {
    const int y = iy + r, x = ix + s;
    if (img < 0 || y < 0 || y >= p.H || x < 0 || x >= p.W) return -1;
    return ((static_cast<long long>(img) * p.H + y) * p.W + x) * p.C + c;
  }
};

// The wgmma route's producer (C % 16 == 0): each 16-byte segment of K lies
// inside one tap, so every thread copies 16 bytes at a time with cp.async,
// segment t % kSegs of the pixel rows and weight rows t / kSegs + kStep j,
// into the swizzled layout: byte (row, k) of a stage at row * kBK +
// ((k / 16) ^ (row * kBK / 128 % kSegs)) * 16 + k % 16.  A warp writes
// whole rows, 512 contiguous bytes, on every bank.
template <int kBN, int kBK>
struct WgLoader {
  static constexpr int kSegs = kBK / 16;                      // 16-byte segments of a row
  static constexpr int kStep = kWgThreads / kSegs;           // rows copied at once
  static constexpr int kARows = kBM / kStep;                  // pixel rows per thread
  static constexpr int kBRows = (kBN + kStep - 1) / kStep;    // weight rows per thread
  PixelRow rows[kARows];
  __device__ static int at(int row, int seg) {
    return row * kBK + ((seg ^ (row * kBK / 128 & (kSegs - 1))) << 4);
  }
  __device__ void init(const ConvParams& p, int m0) {
#pragma unroll
    for (int j = 0; j < kARows; ++j) rows[j].init(p, m0 + threadIdx.x / kSegs + kStep * j);
  }
  __device__ void load(const ConvParams& p, int8_t* as, int8_t* bs, int n0, int kt) const {
    const int seg = threadIdx.x % kSegs;
    const int k = kt * kBK + seg * 16;
    const bool k_in = k < p.K;
    int tap = 0, c = 0, r = 0, s = 0;
    if (k_in) {
      tap = k / p.C;
      c = k - tap * p.C;
      r = tap / p.KW;
      s = tap - r * p.KW;
    }
#pragma unroll
    for (int j = 0; j < kARows; ++j) {
      const int row = threadIdx.x / kSegs + kStep * j;
      const long long off = k_in ? rows[j].offset(p, r, s, c) : -1;
      cp_async16(as + at(row, seg), off >= 0 ? p.x + off : p.x, off >= 0);
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      const int row = threadIdx.x / kSegs + kStep * j;
      if (row < kBN) {
        const int n = n0 + row;
        const bool in = k_in && n < p.F;
        cp_async16(bs + at(row, seg), in ? p.w + static_cast<long long>(n) * p.K + k : p.w, in);
      }
    }
  }
};

// C % 4 == 0 (the 4-channel stem): each 4-byte word of K lies inside one
// tap.  Thread t copies the 16 words of pixel row t and its share of a weight
// row (kMmaThreads / kBN threads a row), 4 bytes at a time with cp.async.
template <int kBN>
struct WordLoader {
  static constexpr int kShare = kBK / (kMmaThreads / kBN);  // weight bytes per thread
  PixelRow row;
  __device__ void init(const ConvParams& p, int m0) { row.init(p, m0 + threadIdx.x); }
  __device__ void load(const ConvParams& p, int8_t* as, int8_t* bs, int n0, int kt) const {
    const int k0 = kt * kBK;
    // the tap (r, s) and channel c of the stage's first word, then stepped
    // word by word
    int c = k0 % p.C, s = k0 / p.C, r = s / p.KW;
    s -= r * p.KW;
    for (int q = 0; q < kBK / 4; ++q) {
      const long long off = k0 + 4 * q < p.K ? row.offset(p, r, s, c) : -1;
      cp_async4(as + threadIdx.x * kRow + 4 * q, off >= 0 ? p.x + off : p.x, off >= 0);
      c += 4;
      if (c == p.C) {
        c = 0;
        if (++s == p.KW) s = 0, ++r;
      }
    }
    const int brow = threadIdx.x / (kMmaThreads / kBN);
    const int n = n0 + brow;
    const int part = (threadIdx.x % (kMmaThreads / kBN)) * kShare;
    for (int q = 0; q < kShare / 4; ++q) {
      const int k = k0 + part + 4 * q;
      const bool in = n < p.F && k < p.K;
      cp_async4(bs + brow * kRow + part + 4 * q, in ? p.w + static_cast<long long>(n) * p.K + k : p.w, in);
    }
  }
};

// Any C: thread t gathers the 64 bytes of pixel row t, and its share of a
// weight row, byte by byte.
template <int kBN>
struct ByteLoader {
  static constexpr int kShare = kBK / (kMmaThreads / kBN);
  PixelRow row;
  __device__ void init(const ConvParams& p, int m0) { row.init(p, m0 + threadIdx.x); }
  __device__ int8_t input_byte(const ConvParams& p, int k) const {
    if (k >= p.K) return 0;
    const int tap = k / p.C;
    const int c = k - tap * p.C;
    const int r = tap / p.KW;
    const long long off = row.offset(p, r, tap - r * p.KW, c);
    return off >= 0 ? p.x[off] : 0;
  }
  __device__ void load(const ConvParams& p, int8_t* as, int8_t* bs, int n0, int kt) const {
    const int k0 = kt * kBK;
    for (int q = 0; q < kBK / 4; ++q) {
      uint32_t word = 0;
      for (int e = 0; e < 4; ++e) {
        word |= static_cast<uint32_t>(static_cast<uint8_t>(input_byte(p, k0 + 4 * q + e))) << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(as + threadIdx.x * kRow + 4 * q) = word;
    }
    const int brow = threadIdx.x / (kMmaThreads / kBN);
    const int n = n0 + brow;
    const int part = (threadIdx.x % (kMmaThreads / kBN)) * kShare;
    for (int q = 0; q < kShare / 4; ++q) {
      uint32_t word = 0;
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + part + 4 * q + e;
        const int8_t v = (n < p.F && k < p.K) ? p.w[static_cast<long long>(n) * p.K + k] : 0;
        word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(bs + brow * kRow + part + 4 * q) = word;
    }
  }
};

// the output value of int32 sum `acc` of a channel with `scale` and `bias`,
// written to dst
template <int kEpi>
__device__ __forceinline__ void store(OutT<kEpi>* dst, int acc, float scale, float bias, float os) {
  if constexpr (kEpi == kRaw) {
    *dst = acc;
  } else {
    float y = __fmaf_rn(__int2float_rn(acc), scale, bias);
    y = y > 0.f ? y : __fmul_rn(y, 0.1f);
    if constexpr (kEpi == kRealF32) {
      *dst = y;
    } else if constexpr (kEpi == kRealBF16) {
      *dst = __float2bfloat16_rn(y);
    } else {
      float q = rintf(kEpi == kQuantDiv ? __fdiv_rn(y, os) : __fmul_rn(y, os));
      q = fminf(fmaxf(q, -127.f), 127.f);
      *dst = static_cast<int8_t>(__float2int_rn(q));
    }
  }
}

// The output tile staged in shared memory.  Row r (pixel m0 + r) starts at
// r * kStride plus its global byte offset mod 16, so that the 16-byte slots
// of shared and of global memory line up: every full slot is one 16-byte
// load and one 16-byte store; a slot cut by a ragged row end (F * size not a
// multiple of 16) is copied byte by byte.
template <int kBN, int kEpi>
struct StagedTile {
  using T = OutT<kEpi>;
  static constexpr int kOb = sizeof(T);
  static constexpr int kStride = stage_stride(kBN, kOb);
  int8_t* smem;
  int m0, n0;
  float os;

  __device__ StagedTile(const ConvParams& p, int8_t* smem_, int m0_, int n0_)
      : smem(smem_), m0(m0_), n0(n0_), os(0.f) {
    if constexpr (kEpi == kQuantDiv) os = *p.oscale;
    if constexpr (kEpi == kQuantRcp) os = __frcp_rn(*p.oscale);
  }
  __device__ long long global_byte(const ConvParams& p, int r) const {
    return (static_cast<long long>(m0 + r) * p.F + n0) * kOb;
  }
  // where row r's values start in shared memory, or nullptr past the last pixel
  __device__ T* row(const ConvParams& p, int r) const {
    if (m0 + r >= p.M) return nullptr;
    return reinterpret_cast<T*>(smem + r * kStride + static_cast<int>(global_byte(p, r) & 15));
  }
  // the scale and bias of channel column col; false past the last channel
  __device__ __forceinline__ bool channel(const ConvParams& p, int col, float& scale, float& bias) const {
    const int n = n0 + col;
    if (n >= p.F) return false;
    if constexpr (kEpi != kRaw) {
      scale = __ldg(p.scale + n);
      bias = __ldg(p.bias + n);
    }
    return true;
  }
  // accumulator acc of channel column col, into row `dst`
  __device__ __forceinline__ void put(T* dst, int col, int acc, float scale, float bias) const {
    if (dst != nullptr) store<kEpi>(dst + col, acc, scale, bias, os);
  }
  // the CTA's rows to global memory, 16 bytes a thread
  __device__ void flush(const ConvParams& p) const {
    const int rows = min(kBM, p.M - m0);
    const int row_bytes = min(kBN, p.F - n0) * kOb;
    // n0 * kOb is a multiple of 32, so with F * kOb a multiple of 16 every
    // row starts on a slot
    const bool aligned = (static_cast<long long>(p.F) * kOb) % 16 == 0;
    const int slots = (row_bytes + 15) / 16 + (aligned ? 0 : 1);
    int8_t* out = static_cast<int8_t*>(p.out);
    for (int i = threadIdx.x; i < rows * slots; i += blockDim.x) {
      const int r = i / slots, sl = i - r * slots;
      const long long g = global_byte(p, r);
      const long long s0 = (g & ~15LL) + 16LL * sl;  // the slot's first global byte
      const int8_t* src = smem + r * kStride + 16 * sl;
      const long long lo = max(s0, g), hi = min(s0 + 16, g + row_bytes);
      if (hi - lo == 16) {
        *reinterpret_cast<int4*>(out + s0) = *reinterpret_cast<const int4*>(src);
      } else {
        for (long long b = lo; b < hi; ++b) out[b] = src[b - s0];
      }
    }
  }
};

// the mma.sync routes
template <int kRoute, int kBN, int kEpi>
__device__ __forceinline__ void mma_tile(const ConvParams& p) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int kAStage = kBM * kRow;
  constexpr int kBStage = kBN * kRow;
  int8_t* a_smem = smem;
  int8_t* b_smem = smem + kMmaStages * kAStage;

  // warps: 2 x 2 of 64 x 32 at BN = 64, 4 x 1 of 32 x 32 at BN = 32
  constexpr int kWarpsM = 4 / (kBN / 32);
  constexpr int kMI = kBM / kWarpsM / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // consecutive CTAs share a pixel tile, so its input is read from L2
  const int m0 = (blockIdx.x / p.n_tiles) * kBM;
  const int n0 = (blockIdx.x % p.n_tiles) * kBN;
  const int wm = (warp % kWarpsM) * (kMI * 16), wn = (warp / kWarpsM) * 32;
  const int nk = (p.K + kBK - 1) / kBK;

  typename std::conditional<kRoute == kRouteWord, WordLoader<kBN>, ByteLoader<kBN>>::type loader;
  loader.init(p, m0);

  int acc[kMI][4][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < nk) loader.load(p, a_smem + st * kAStage, b_smem + st * kBStage, n0, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // stage kt has landed, and stage kt-1 is consumed
    const int next = kt + kMmaStages - 1;
    if (next < nk) {
      const int st = next % kMmaStages;
      loader.load(p, a_smem + st * kAStage, b_smem + st * kBStage, n0, next);
    }
    cp_async_commit();

    const int8_t* as = a_smem + (kt % kMmaStages) * kAStage;
    const int8_t* bs = b_smem + (kt % kMmaStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kMI][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const int8_t* pa = as + (wm + mi * 16 + g) * kRow + kk + 4 * t;
        af[mi][0] = lds32(pa);
        af[mi][1] = lds32(pa + 8 * kRow);
        af[mi][2] = lds32(pa + 16);
        af[mi][3] = lds32(pa + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* pb = bs + (wn + ni * 8 + g) * kRow + kk + 4 * t;
        bf[ni][0] = lds32(pb);
        bf[ni][1] = lds32(pb + 16);
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the staged tile

  // accumulator e of tile (mi, ni) is pixel row g + 8 (e / 2), channel
  // column 2t + (e % 2)
  StagedTile<kBN, kEpi> tile(p, smem, m0, n0);
  OutT<kEpi>* dst[kMI][2];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) dst[mi][h] = tile.row(p, wm + mi * 16 + g + 8 * h);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn + ni * 8 + 2 * t + e;
      float scale = 0.f, bias = 0.f;
      if (!tile.channel(p, col, scale, bias)) continue;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) tile.put(dst[mi][h], col, acc[mi][ni][2 * h + e], scale, bias);
    }
  }
  __syncthreads();
  tile.flush(p);
}

// the wgmma route
template <int kBN, int kBK, int kEpi>
__device__ __forceinline__ void wgmma_tile(const ConvParams& p) {
  extern __shared__ __align__(1024) int8_t smem[];  // stages on 1024 bytes, for the swizzle
  constexpr int kStages = stages_of(kRouteWgmma, kBK);
  constexpr int kAStage = kBM * kBK;
  constexpr int kBStage = kBN * kBK;
  constexpr int kAhead = kStages - 2;  // stages loaded ahead of the one multiplied
  int8_t* a_smem = smem;
  int8_t* b_smem = smem + kStages * kAStage;

  const int wg = threadIdx.x >> 7;  // this warpgroup's 64 pixel rows
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // consecutive CTAs share a pixel tile, so its input is read from L2
  const int m0 = (blockIdx.x / p.n_tiles) * kBM;
  const int n0 = (blockIdx.x % p.n_tiles) * kBN;
  const int nk = (p.K + kBK - 1) / kBK;

  WgLoader<kBN, kBK> loader;
  loader.init(p, m0);

  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int st = 0; st < kAhead; ++st) {
    if (st < nk) loader.load(p, a_smem + st * kAStage, b_smem + st * kBStage, n0, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of stage kt have landed
    fence_proxy_async();
    // stage kt is visible to both warpgroups; each has retired the group
    // that read stage kt - 2, whose slot is refilled next
    __syncthreads();
    const int next = kt + kAhead;
    if (next < nk) {
      const int st = next % kStages;
      loader.load(p, a_smem + st * kAStage, b_smem + st * kBStage, n0, next);
    }
    cp_async_commit();

    const int8_t* as = a_smem + (kt % kStages) * kAStage + wg * 64 * kBK;
    const int8_t* bs = b_smem + (kt % kStages) * kBStage;
    fence_accumulators(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      wgmma_s8<kBN>(acc, smem_desc<kBK>(as + kk * 32), smem_desc<kBK>(bs + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of stage kt - 1 has retired
    fence_accumulators(acc);
  }
  wgmma_wait<0>();
  fence_accumulators(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the staged tile

  StagedTile<kBN, kEpi> tile(p, smem, m0, n0);
  OutT<kEpi>* dst[2] = {tile.row(p, wg * 64 + warp * 16 + g), tile.row(p, wg * 64 + warp * 16 + g + 8)};
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * i + 2 * t + e;
      float scale = 0.f, bias = 0.f;
      if (!tile.channel(p, col, scale, bias)) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) tile.put(dst[h], col, acc[4 * i + 2 * h + e], scale, bias);
    }
  }
  __syncthreads();
  tile.flush(p);
}

template <int kRoute, int kBN, int kBK, int kEpi>
__device__ __forceinline__ void conv_tile(const ConvParams& p) {
  if constexpr (kRoute == kRouteWgmma) {
    wgmma_tile<kBN, kBK, kEpi>(p);
  } else {
    mma_tile<kRoute, kBN, kEpi>(p);
  }
}

template <int kRoute, int kBN, int kBK, int kEpi>
__global__ void __launch_bounds__(threads_of(kRoute)) int8_conv_kernel(const ConvParams p) {
  conv_tile<kRoute, kBN, kBK, kEpi>(p);
}

// K3: the 3x3 / stride-2 / pad-1 downsample with the reciprocal epilogue
template <int kRoute, int kBN, int kBK>
__global__ void __launch_bounds__(threads_of(kRoute)) int8_downsample_kernel(const ConvParams p) {
  conv_tile<kRoute, kBN, kBK, kQuantRcp>(p);
}

// The route and tile of a launch, as the plan gives them.
struct Tile {
  int route, bm, bn, bk, stages, smem, grid;
};

// Fills p; returns the CTAs of the launch, or -1 on shapes the kernels do not
// take or a tile they were not built for.
int setup(ConvParams& p, const Tile& tile, const void* x, const void* w, const void* scale,
          const void* bias, const void* oscale, void* out, int B, int H, int W, int C, int F, int KH,
          int KW, int stride) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || KH < 1 || KW < 1 || stride < 1) return -1;
  const bool wide = tile.route == kRouteWgmma;
  if (tile.route < kRouteByte || tile.route > kRouteWgmma || tile.bm != kBM ||
      (tile.bn != 32 && tile.bn != 64 && !(wide && tile.bn == 128)) ||
      (tile.bk != 64 && !(wide && tile.bn == 128 && tile.bk == 128)) ||
      tile.stages != stages_of(tile.route, tile.bk) ||
      tile.smem != smem_bytes(tile.route, tile.bn, tile.bk)) {
    return -1;
  }
  // the widest copies that C and the pointers' alignment allow
  const auto aligned = [&](int n) {
    return C % n == 0 && reinterpret_cast<uintptr_t>(x) % n == 0 && reinterpret_cast<uintptr_t>(w) % n == 0;
  };
  if ((tile.route == kRouteWgmma && !aligned(16)) || (tile.route == kRouteWord && !aligned(4))) return -1;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.oscale = static_cast<const float*>(oscale);
  p.out = out;
  p.B = B, p.H = H, p.W = W, p.C = C, p.F = F, p.KH = KH, p.KW = KW, p.stride = stride;
  p.pad = KH / 2;
  p.Ho = (H + 2 * p.pad - KH) / stride + 1;
  p.Wo = (W + 2 * (KW / 2) - KW) / stride + 1;
  const long long m = static_cast<long long>(B) * p.Ho * p.Wo;
  const long long k = static_cast<long long>(KH) * KW * C;
  p.n_tiles = (F + tile.bn - 1) / tile.bn;
  const long long blocks = (m + kBM - 1) / kBM * p.n_tiles;
  if (p.Ho < 1 || p.Wo < 1 || m > 0x7fffffffLL || k > 0x7fffffffLL || blocks != tile.grid) return -1;
  p.M = static_cast<int>(m);
  p.K = static_cast<int>(k);
  return static_cast<int>(blocks);
}

template <int kRoute, int kBN, int kBK, int kEpi>
cudaError_t launch_tile(const ConvParams& p, const Tile& tile, cudaStream_t stream) {
  void (*kernel)(ConvParams);
  if constexpr (kEpi == kQuantRcp) {
    kernel = int8_downsample_kernel<kRoute, kBN, kBK>;
  } else {
    kernel = int8_conv_kernel<kRoute, kBN, kBK, kEpi>;
  }
  if (tile.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<tile.grid, threads_of(kRoute), tile.smem, stream>>>(p);
  return cudaGetLastError();
}

template <int kRoute, int kEpi>
cudaError_t launch_route(const ConvParams& p, const Tile& tile, cudaStream_t stream) {
  if (tile.bn == 32) return launch_tile<kRoute, 32, 64, kEpi>(p, tile, stream);
  if constexpr (kRoute == kRouteWgmma) {
    if (tile.bn == 128) {
      return tile.bk == 128 ? launch_tile<kRoute, 128, 128, kEpi>(p, tile, stream)
                            : launch_tile<kRoute, 128, 64, kEpi>(p, tile, stream);
    }
  }
  return launch_tile<kRoute, 64, 64, kEpi>(p, tile, stream);
}

template <int kEpi>
cudaError_t launch(const ConvParams& p, const Tile& tile, cudaStream_t stream) {
  switch (tile.route) {
    case kRouteWgmma: return launch_route<kRouteWgmma, kEpi>(p, tile, stream);
    case kRouteWord: return launch_route<kRouteWord, kEpi>(p, tile, stream);
    default: return launch_route<kRouteByte, kEpi>(p, tile, stream);
  }
}

}  // namespace

// The direct int8 conv cell: x (B, H, W, C) int8, w (F, KH, KW, C) int8, both
// dense; pad KH/2; out (B, Ho, Wo, F), dense, of the epilogue's type: epi 0
// int32 (scale, bias, oscale unused), 1 float32, 2 bf16 (oscale unused), 3
// int8 requantised by division by *oscale.  scale, bias (F,) float32 and
// oscale (scalar float32) lie on the device.  route, bm, bn, bk, stages, smem
// and grid are the plan's (ops/int8_conv_kernel.py:plan).  Returns the CUDA error
// of the launch (0 on success).
extern "C" int int8_conv_launch(const void* x, const void* w, const void* scale, const void* bias,
                                const void* oscale, void* out, int B, int H, int W, int C, int F,
                                int KH, int KW, int stride, int epi, int route, int bm, int bn,
                                int bk, int stages, int smem, int grid, void* stream) {
  ConvParams p;
  const Tile tile{route, bm, bn, bk, stages, smem, grid};
  if (setup(p, tile, x, w, scale, bias, oscale, out, B, H, W, C, F, KH, KW, stride) < 0 || KH != KW ||
      KH % 2 == 0) {
    return cudaErrorInvalidValue;
  }
  if (epi != kRaw && (scale == nullptr || bias == nullptr)) return cudaErrorInvalidValue;
  if (epi == kQuantDiv && oscale == nullptr) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kRaw: return launch<kRaw>(p, tile, st);
    case kRealF32: return launch<kRealF32>(p, tile, st);
    case kRealBF16: return launch<kRealBF16>(p, tile, st);
    case kQuantDiv: return launch<kQuantDiv>(p, tile, st);
    default: return cudaErrorInvalidValue;
  }
}

// K3: x (B, H, W, C) int8, w (F, 3, 3, C) int8, both dense; out (B, Ho, Wo,
// F) int8, Ho = (H + 1) / 2; the epilogue multiplies by 1 / *oscale.  The
// tile is the plan's.  Returns the CUDA error of the launch (0 on success).
extern "C" int int8_downsample_launch(const void* x, const void* w, const void* scale,
                                      const void* bias, const void* oscale, void* out, int B,
                                      int H, int W, int C, int F, int route, int bm, int bn,
                                      int bk, int stages, int smem, int grid, void* stream) {
  ConvParams p;
  const Tile tile{route, bm, bn, bk, stages, smem, grid};
  if (setup(p, tile, x, w, scale, bias, oscale, out, B, H, W, C, F, 3, 3, 2) < 0 ||
      scale == nullptr || bias == nullptr || oscale == nullptr) {
    return cudaErrorInvalidValue;
  }
  return launch<kQuantRcp>(p, tile, static_cast<cudaStream_t>(stream));
}
