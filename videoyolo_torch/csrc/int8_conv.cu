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
// int8_conv_plain; Python wrappers: videoyolo_torch/ops/int8_conv_kernel.py.
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
//
// Bound on an H100 SXM at its 700 W peaks (B=128, 416 px; chip_smoke.py
// computes it per cell): K3's cell at a 208x208x64 input moves 354 MB in and
// 177 MB out, 0.16 ms at 3.35 TB/s, against 0.10 ms of int8 operations at
// 1,979 TOP/s: bytes.  Its other three cells, and most direct 3x3 cells, are
// bound by int8 operations; the 1x1 cells are near the balance point.
//
// Design: an implicit GEMM.  M = the B*Ho*Wo output pixels, N = the F output
// channels, K = KH*KW*C, taken tap by tap (k = (r*KW + s)*C + c).  One CTA of
// four warps takes a 128-pixel x 64-channel output tile; each warp a 64 x 32
// block, as 4 x 4 mma.sync.m16n8k32 s8 tiles with int32 accumulators in
// registers.  K advances 64 bytes at a time through a 3-stage ring of shared
// memory tiles filled by cp.async: for each output pixel of the tile, the 64
// input bytes that the current taps reach (the input tile with its halo,
// taken tap by tap), zero-filled outside the image, and the matching 64
// bytes of each of the 64 weight rows.  Rows are padded to 80 bytes, so the
// fragment loads of a warp hit 32 different banks.  When C is not a multiple
// of 16 the copies are 4 bytes wide (C % 4 == 0: the 4-channel stem) or single
// bytes (any C).  The epilogue runs in registers and stores each output value
// once.
// What is left for later: wgmma and TMA, the output staged through shared
// memory for wide stores, and one halo tile per CTA reused across the taps
// (the input is now re-read per tap, from L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;     // output pixels per CTA
constexpr int kBN = 64;      // output channels per CTA
constexpr int kBK = 64;      // bytes of K per stage
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kThreads = 128;
constexpr int kRow = kBK + 16;  // padded shared-memory row: 16-byte aligned, no bank conflicts
constexpr int kAStage = kBM * kRow;
constexpr int kBStage = kBN * kRow;
constexpr int kSmem = kStages * (kAStage + kBStage);  // 46,080 bytes

// epilogues
constexpr int kRaw = 0;        // int32 sums
constexpr int kRealF32 = 1;    // leaky(fma(acc, scale, bias)) as float32
constexpr int kRealBF16 = 2;   // ... as bf16
constexpr int kQuantDiv = 3;   // int8: rint(y / oscale) clipped (the direct cells)
constexpr int kQuantRcp = 4;   // int8: rint(y * (1 / oscale)) clipped (K3)

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

// C % 16 == 0: each 16-byte segment of K lies inside one tap, so the tiles
// are copied 16 bytes at a time with cp.async.  Thread t copies segment t % 4
// of the rows t / 4 + 32 j.
struct VecLoader {
  PixelRow rows[kBM / 32];
  __device__ void init(const ConvParams& p, int m0) {
#pragma unroll
    for (int j = 0; j < kBM / 32; ++j) rows[j].init(p, m0 + (threadIdx.x >> 2) + 32 * j);
  }
  __device__ void load(const ConvParams& p, int8_t* as, int8_t* bs, int n0, int kt) const {
    const int seg = threadIdx.x & 3;
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
    for (int j = 0; j < kBM / 32; ++j) {
      const int row = (threadIdx.x >> 2) + 32 * j;
      const long long off = k_in ? rows[j].offset(p, r, s, c) : -1;
      cp_async16(as + row * kRow + seg * 16, off >= 0 ? p.x + off : p.x, off >= 0);
    }
#pragma unroll
    for (int j = 0; j < kBN / 32; ++j) {
      const int row = (threadIdx.x >> 2) + 32 * j;
      const int n = n0 + row;
      const bool in = k_in && n < p.F;
      cp_async16(bs + row * kRow + seg * 16, in ? p.w + static_cast<long long>(n) * p.K + k : p.w, in);
    }
  }
};

// C % 4 == 0 (the 4-channel stem): each 4-byte word of K lies inside one
// tap.  Thread t copies the 16 words of pixel row t and 8 words of weight row
// t / 2, 4 bytes at a time with cp.async.
struct WordLoader {
  PixelRow row;
  __device__ void init(const ConvParams& p, int m0) { row.init(p, m0 + threadIdx.x); }
  __device__ void load(const ConvParams& p, int8_t* as, int8_t* bs, int n0, int kt) const {
    const int k0 = kt * kBK;
    for (int q = 0; q < kBK / 4; ++q) {
      const int k = k0 + 4 * q;
      long long off = -1;
      if (k < p.K) {
        const int tap = k / p.C;
        const int r = tap / p.KW;
        off = row.offset(p, r, tap - r * p.KW, k - tap * p.C);
      }
      cp_async4(as + threadIdx.x * kRow + 4 * q, off >= 0 ? p.x + off : p.x, off >= 0);
    }
    const int brow = threadIdx.x >> 1;
    const int n = n0 + brow;
    const int half = (threadIdx.x & 1) * (kBK / 2);
    for (int q = 0; q < kBK / 8; ++q) {
      const int k = k0 + half + 4 * q;
      const bool in = n < p.F && k < p.K;
      cp_async4(bs + brow * kRow + half + 4 * q, in ? p.w + static_cast<long long>(n) * p.K + k : p.w, in);
    }
  }
};

// Any C: thread t gathers the 64 bytes of pixel row t, and half a weight row,
// byte by byte.
struct ByteLoader {
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
    const int brow = threadIdx.x >> 1;
    const int n = n0 + brow;
    const int kb = k0 + (threadIdx.x & 1) * (kBK / 2);
    for (int q = 0; q < kBK / 8; ++q) {
      uint32_t word = 0;
      for (int e = 0; e < 4; ++e) {
        const int k = kb + 4 * q + e;
        const int8_t v = (n < p.F && k < p.K) ? p.w[static_cast<long long>(n) * p.K + k] : 0;
        word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(bs + brow * kRow + (threadIdx.x & 1) * (kBK / 2) + 4 * q) = word;
    }
  }
};

template <int kEpi>
__device__ __forceinline__ void store(const ConvParams& p, long long idx, int n, int acc, float os) {
  if (kEpi == kRaw) {
    static_cast<int*>(p.out)[idx] = acc;
    return;
  }
  float y = __fmaf_rn(__int2float_rn(acc), p.scale[n], p.bias[n]);
  y = y > 0.f ? y : __fmul_rn(y, 0.1f);
  if (kEpi == kRealF32) {
    static_cast<float*>(p.out)[idx] = y;
  } else if (kEpi == kRealBF16) {
    static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
  } else {
    float q = rintf(kEpi == kQuantDiv ? __fdiv_rn(y, os) : __fmul_rn(y, os));
    q = fminf(fmaxf(q, -127.f), 127.f);
    static_cast<int8_t*>(p.out)[idx] = static_cast<int8_t>(__float2int_rn(q));
  }
}

// how a stage is filled
constexpr int kLoadByte = 0;
constexpr int kLoadWord = 1;
constexpr int kLoadVec = 2;

template <int kLoad, int kEpi>
__device__ __forceinline__ void conv_tile(const ConvParams& p) {
  __shared__ __align__(16) int8_t smem[kSmem];
  int8_t* a_smem = smem;
  int8_t* b_smem = smem + kStages * kAStage;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // consecutive CTAs share a pixel tile, so its input is read from L2
  const int m0 = (blockIdx.x / p.n_tiles) * kBM;
  const int n0 = (blockIdx.x % p.n_tiles) * kBN;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int nk = (p.K + kBK - 1) / kBK;

  typename std::conditional<
      kLoad == kLoadVec, VecLoader,
      typename std::conditional<kLoad == kLoadWord, WordLoader, ByteLoader>::type>::type loader;
  loader.init(p, m0);

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) loader.load(p, a_smem + st * kAStage, b_smem + st * kBStage, n0, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed, and stage kt-1 is consumed
    const int next = kt + kStages - 1;
    if (next < nk) {
      const int st = next % kStages;
      loader.load(p, a_smem + st * kAStage, b_smem + st * kBStage, n0, next);
    }
    cp_async_commit();

    const int8_t* as = a_smem + (kt % kStages) * kAStage;
    const int8_t* bs = b_smem + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
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
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  // epilogue: accumulator e of tile (mi, ni) is pixel row g + 8 (e / 2),
  // channel 2t + (e % 2)
  float os = 0.f;
  if (kEpi == kQuantDiv) os = *p.oscale;
  if (kEpi == kQuantRcp) os = __frcp_rn(*p.oscale);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + ni * 8 + 2 * t + e;
          if (n < p.F) store<kEpi>(p, static_cast<long long>(m) * p.F + n, n, acc[mi][ni][2 * h + e], os);
        }
      }
    }
  }
}

template <int kLoad, int kEpi>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const ConvParams p) {
  conv_tile<kLoad, kEpi>(p);
}

// K3: the 3x3 / stride-2 / pad-1 downsample with the reciprocal epilogue
template <int kLoad>
__global__ void __launch_bounds__(kThreads) int8_downsample_kernel(const ConvParams p) {
  conv_tile<kLoad, kQuantRcp>(p);
}

int setup(ConvParams& p, const void* x, const void* w, const void* scale, const void* bias,
          const void* oscale, void* out, int B, int H, int W, int C, int F, int KH, int KW,
          int stride) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || KH < 1 || KW < 1 || stride < 1) return -1;
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
  p.n_tiles = (F + kBN - 1) / kBN;
  const long long blocks = (m + kBM - 1) / kBM * p.n_tiles;
  if (p.Ho < 1 || p.Wo < 1 || m > 0x7fffffffLL || k > 0x7fffffffLL || blocks > 0x7fffffffLL) {
    return -1;
  }
  p.M = static_cast<int>(m);
  p.K = static_cast<int>(k);
  return static_cast<int>(blocks);
}

// the widest copies that C and the pointers' alignment allow
int load_kind(const ConvParams& p) {
  const auto aligned = [&](int n) {
    return p.C % n == 0 && reinterpret_cast<uintptr_t>(p.x) % n == 0 &&
           reinterpret_cast<uintptr_t>(p.w) % n == 0;
  };
  return aligned(16) ? kLoadVec : aligned(4) ? kLoadWord : kLoadByte;
}

template <int kEpi>
cudaError_t launch_conv(const ConvParams& p, int blocks, cudaStream_t stream) {
  switch (load_kind(p)) {
    case kLoadVec: int8_conv_kernel<kLoadVec, kEpi><<<blocks, kThreads, 0, stream>>>(p); break;
    case kLoadWord: int8_conv_kernel<kLoadWord, kEpi><<<blocks, kThreads, 0, stream>>>(p); break;
    default: int8_conv_kernel<kLoadByte, kEpi><<<blocks, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// The direct int8 conv cell: x (B, H, W, C) int8, w (F, KH, KW, C) int8, both
// dense; pad KH/2; out (B, Ho, Wo, F), dense, of the epilogue's type: epi 0
// int32 (scale, bias, oscale unused), 1 float32, 2 bf16 (oscale unused), 3
// int8 requantised by division by *oscale.  scale, bias (F,) float32 and
// oscale (scalar float32) lie on the device.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int int8_conv_launch(const void* x, const void* w, const void* scale, const void* bias,
                                const void* oscale, void* out, int B, int H, int W, int C, int F,
                                int KH, int KW, int stride, int epi, void* stream) {
  ConvParams p;
  const int blocks = setup(p, x, w, scale, bias, oscale, out, B, H, W, C, F, KH, KW, stride);
  if (blocks < 0 || KH != KW || KH % 2 == 0) return cudaErrorInvalidValue;
  if (epi != kRaw && (scale == nullptr || bias == nullptr)) return cudaErrorInvalidValue;
  if (epi == kQuantDiv && oscale == nullptr) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kRaw: return launch_conv<kRaw>(p, blocks, st);
    case kRealF32: return launch_conv<kRealF32>(p, blocks, st);
    case kRealBF16: return launch_conv<kRealBF16>(p, blocks, st);
    case kQuantDiv: return launch_conv<kQuantDiv>(p, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

// K3: x (B, H, W, C) int8, w (F, 3, 3, C) int8, both dense; out (B, Ho, Wo,
// F) int8, Ho = (H + 1) / 2; the epilogue multiplies by 1 / *oscale.
// Returns the CUDA error of the launch (0 on success).
extern "C" int int8_downsample_launch(const void* x, const void* w, const void* scale,
                                      const void* bias, const void* oscale, void* out, int B,
                                      int H, int W, int C, int F, void* stream) {
  ConvParams p;
  const int blocks = setup(p, x, w, scale, bias, oscale, out, B, H, W, C, F, 3, 3, 2);
  if (blocks < 0 || scale == nullptr || bias == nullptr || oscale == nullptr) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (load_kind(p)) {
    case kLoadVec: int8_downsample_kernel<kLoadVec><<<blocks, kThreads, 0, st>>>(p); break;
    case kLoadWord: int8_downsample_kernel<kLoadWord><<<blocks, kThreads, 0, st>>>(p); break;
    default: int8_downsample_kernel<kLoadByte><<<blocks, kThreads, 0, st>>>(p);
  }
  return cudaGetLastError();
}
