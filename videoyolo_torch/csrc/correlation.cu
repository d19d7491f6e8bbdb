// Correlation cost volume (FlowNet / Caffe lineage) for Hopper (sm_90a).
//
// Ports the TPU kernel videoyolo_tpu/ops/pallas_correlation.py:
// correlation_pallas (body _corr_kernel), the JAX package's default for the
// configuration kernel_size=1, stride1=1, multiply.  Plain PyTorch version:
// videoyolo_torch/ops/correlation.py:correlation_plain; Python wrapper and
// work plan: videoyolo_torch/ops/correlation_kernel.py:cost_volume, plan.
//
// What it computes, for f1, f2 (B, H, W, C) float32, displacement d and
// stride2, with s = d / stride2, steps = 2s+1 and D = steps^2:
//   out[b, y, x, iy*steps + ix] = sum_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c] / C
//   dy = (iy - s) * stride2, dx = (ix - s) * stride2, f2 zero outside the image.
// The output is NHWC (B, H, W, D): an NCHW tensor in channels_last memory,
// so the concat that follows in the Corr layer needs no permute copy.
//
// Bound on an H100 SXM at its 700 W peaks (main path, B=32, d=4, stride2=1,
// D=81): at 52x52x256 the kernel must read 177 MB of f1 and f2 and write
// 28 MB, 0.061 ms at 3.35 TB/s, and do 3.3 GFLOP of f32 multiply-adds on the
// products inside the image, 0.049 ms at 67 TFLOP/s.  Bytes and work are
// nearly balanced (about 16 FLOP per byte).
//
// Design: one CTA per (image, tile of 8 rows x TW columns of output pixels,
// group of GY x GX displacements), one or two warps side by side.
//  * Staging, pixel-major.  A chunk of 16 channels of the f1 tile and of the
//    f2 window the group reaches (the tile plus a halo) is staged in shared
//    memory as [row][pixel][16 channels], as the inputs lie in device memory
//    (C contiguous), so one 16-byte cp.async moves 4 channels of one pixel
//    (zero-filled outside the image).  Inputs with C % 4 != 0 or pointers and
//    batch strides that are not 16-byte aligned take 4-byte copies into the
//    same layout, zero past C.  Each staged row ends in 16 bytes of padding,
//    so a row spans an odd number of 16-byte units.
//  * A register tile.  Lane l of a warp takes tile row l % 8 and R
//    neighbouring pixels from column (4 * warp + l / 8) * R: the 8 lanes of a
//    quarter-warp read 8 rows at one column, which the odd row span puts in
//    8 distinct groups of banks, so every 16-byte shared load is free of
//    conflicts.  Per 4 channels a thread loads its R f1 pixels and, for each
//    of the group's GY displacement rows, the R + GX - 1 f2 pixels its R
//    pixels reach (R = 2 only where stride2 == 1), and does 4*R*GX*GY
//    multiply-adds: at R=2, GX=9, GY=3, 32 loads of 16 bytes for 216 FMAs,
//    at R=1 28 for 108, where one thread per pixel and a channel-major chunk
//    needed a 4-byte load per FMA.  Each (pixel, displacement) is summed in
//    channel order.
//  * R, GX and GY are template arguments, so the R*GX*GY accumulators live
//    in registers; displacements of a ragged last group are computed on
//    staged zeros and not written.  The tile width, the group and the grid
//    are the plan's (correlation_kernel.plan), which this file checks.
//  * The results go through shared memory and leave as each pixel's run of
//    the group's contiguous displacements.
// No double buffering and no split over C: the CTAs of an SM overlap one's
// staging with another's arithmetic, so the plan favours small CTAs on
// 8x8-pixel tiles (one warp at R=2, two at R=1), many to an SM.  R=4 (184
// registers at GX=9, GY=3) was an instance and lost at every level on an
// H100: too few warps an SM to hide the staging's latency.
// Measured (H100 80GB HBM3, 700 W limit, chip_smoke.py): 0.369 / 0.226 /
// 0.256 ms a launch at 52x52x256 / 26x26x512 / 13x13x1024 (B=32, d=4), 6-19x
// the bound, against 0.670 / 0.382 / 0.472 for one thread a pixel on
// channel-major chunks.  What bounds it now: each CTA waits for its chunk's
// copies and then computes, with nothing of its own in flight, so the copies'
// latency shows wherever an SM holds few CTAs (13x13: 384 CTAs); the 8x8
// tiles re-stage f2 about 2.5 times a group (the window is 10x16 pixels);
// and at R <= 2 the arithmetic still needs 0.15-0.26 16-byte shared loads a
// multiply-add.  Without the row padding the kernel was 2.3-4x slower
// (probe_cost_volume.py).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 8;        // tile rows: one per lane of a quarter-warp
constexpr int kChunk = 16;      // channels staged at a time: 64 bytes a pixel
constexpr int kRowPad = 4;      // floats (16 bytes) after each staged row
constexpr int kMaxWarps = 2;    // warps per CTA, side by side
constexpr int kMaxSmem = 112 * 1024;
constexpr int kMaxGroups = 65535;  // the grid's y extent

// floats in one staged row of n pixels: an odd number of 16-byte units
__host__ __device__ constexpr int row_floats(int n) { return n * kChunk + kRowPad; }

struct Params {
  const float* f1;
  const float* f2;
  float* out;
  long long bs1, bs2;  // batch strides, elements
  int H, W, C, steps, s2;
  int tw, tiles_x, groups_x, halo_w, halo_h;
  int vec;  // 16-byte copies, else 4-byte ones
};

// 16 bytes from device to shared memory, asynchronously, bypassing L1; zero
// when !valid (no bytes are read then; src must still be a device address)
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// Stages rows x cols pixels from (y0, x0) of one image, channels c0 ..
// c0+kChunk-1, into rows of row_floats(cols) floats.  16-byte copies skip
// the units past C (the arithmetic does not read them); 4-byte copies
// zero-fill past C, so the last 4 channels read are zeros beyond C.
__device__ __forceinline__ void stage(float* dst, const float* src, int y0, int x0, int rows,
                                      int cols, int c0, const Params& p) {
  const int n = blockDim.x;
  if (p.vec) {
    constexpr int per_pixel = kChunk / 4;
    const int units = cols * per_pixel;
    for (int r = 0; r < rows; ++r) {
      const int y = y0 + r;
      const bool row_in = y >= 0 && y < p.H;
      float* d = dst + r * row_floats(cols);
      for (int u = threadIdx.x; u < units; u += n) {
        const int x = x0 + u / per_pixel, c = c0 + (u % per_pixel) * 4;
        if (c >= p.C) continue;
        const bool in = row_in && x >= 0 && x < p.W;
        copy16(d + u * 4, in ? src + (static_cast<long long>(y) * p.W + x) * p.C + c : src, in);
      }
    }
  } else {
    const int units = cols * kChunk;
    for (int r = 0; r < rows; ++r) {
      const int y = y0 + r;
      const bool row_in = y >= 0 && y < p.H;
      float* d = dst + r * row_floats(cols);
      for (int u = threadIdx.x; u < units; u += n) {
        const int x = x0 + u / kChunk, c = c0 + u % kChunk;
        const bool in = row_in && x >= 0 && x < p.W && c < p.C;
        copy4(d + u, in ? src + (static_cast<long long>(y) * p.W + x) * p.C + c : src, in);
      }
    }
  }
}

__device__ __forceinline__ float4 load4(const float* s) { return *reinterpret_cast<const float4*>(s); }

// blockIdx.y, read anew at each call, so the group's origin is recomputed
// after the main loop rather than held in registers across it
__device__ __forceinline__ int group_index() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
  return v;
}

// acc += f . g over 4 channels, in channel order
__device__ __forceinline__ void dot4(float& acc, const float4& f, const float4& g) {
  acc = fmaf(f.x, g.x, acc);
  acc = fmaf(f.y, g.y, acc);
  acc = fmaf(f.z, g.z, acc);
  acc = fmaf(f.w, g.w, acc);
}

// at least one CTA an SM: without it ptxas held several instances below the
// registers they need, for occupancy, and spilled a few bytes in each
template <int R, int GX, int GY>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
cost_volume_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int s1_row = row_floats(p.tw), s2_row = row_floats(p.halo_w);
  float* s1 = smem;                     // [kRows][tw][kChunk] + pad: f1 tile
  float* sf2 = smem + kRows * s1_row;   // [halo_h][halo_w][kChunk] + pad: f2 window

  const int lane = threadIdx.x % 32;
  const int ty = lane % 8;                                  // tile row
  const int cx = ((threadIdx.x / 32) * 4 + lane / 8) * R;   // first tile column
  const int y0 = (blockIdx.x / p.tiles_x) * kRows;
  const int x0 = (blockIdx.x % p.tiles_x) * p.tw;
  // this CTA's displacements: rows iy0.. and columns ix0.. of the grid; the
  // f2 window: pixel (y0+ty, x0+cx+r) at displacement (iy0+jy, ix0+jx) reads
  // window row ty + jy*s2, column cx + r + jx*s2
  const int s = p.steps / 2;
  const int hy0 = y0 + ((group_index() / p.groups_x) * GY - s) * p.s2;
  const int hx0 = x0 + ((group_index() % p.groups_x) * GX - s) * p.s2;
  const float* a = p.f1 + blockIdx.z * p.bs1;
  const float* b = p.f2 + blockIdx.z * p.bs2;
  const float* t1 = s1 + ty * s1_row + cx * kChunk;
  const float* t2 = sf2 + ty * s2_row + cx * kChunk;
  const int dy_step = p.s2 * s2_row, dx_step = p.s2 * kChunk;

  float acc[R][GX * GY];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < GX * GY; ++k) acc[r][k] = 0.f;
  }

  for (int c0 = 0; c0 < p.C; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    stage(s1, a, y0, x0, kRows, p.tw, c0, p);
    stage(sf2, b, hy0, hx0, p.halo_h, p.halo_w, c0, p);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int nq = (min(kChunk, p.C - c0) + 3) / 4;
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
      float4 f[R];
#pragma unroll
      for (int r = 0; r < R; ++r) f[r] = load4(t1 + r * kChunk + q * 4);
#pragma unroll
      for (int jy = 0; jy < GY; ++jy) {
        const float* row = t2 + jy * dy_step + q * 4;
        if constexpr (R == 1) {
#pragma unroll
          for (int jx = 0; jx < GX; ++jx) dot4(acc[0][jy * GX + jx], f[0], load4(row + jx * dx_step));
        } else {
          // stride2 == 1: pixel r at displacement column jx reads window
          // column cx + r + jx, so each f2 pixel loaded serves up to R pixels
#pragma unroll
          for (int k = 0; k < R + GX - 1; ++k) {
            const float4 g = load4(row + k * kChunk);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (k - r >= 0 && k - r < GX) dot4(acc[r][jy * GX + k - r], f[r], g);
            }
          }
        }
      }
    }
  }

  // stage the sums, then write each pixel's run of the group's
  // displacements (whole rows of the grid, or one row: contiguous channels),
  // divided by C on the way out
  const int iy0 = (group_index() / p.groups_x) * GY;
  const int ix0 = (group_index() % p.groups_x) * GX;
  const int ny = min(GY, p.steps - iy0), nx = min(GX, p.steps - ix0);
  const int g = ny * nx, gs = g | 1;
  __syncthreads();
  float* so = smem;  // [kRows * tw][gs]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int pix = ty * p.tw + cx + r;
#pragma unroll
    for (int jy = 0; jy < GY; ++jy) {
#pragma unroll
      for (int jx = 0; jx < GX; ++jx) {
        if (jy < ny && jx < nx) so[pix * gs + jy * nx + jx] = acc[r][jy * GX + jx];
      }
    }
  }
  __syncthreads();
  const int D = p.steps * p.steps;
  const float norm = static_cast<float>(p.C);
  float* o = p.out + static_cast<long long>(blockIdx.z) * p.H * p.W * D + iy0 * p.steps + ix0;
  const int total = kRows * p.tw * g;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int pix = i / g, j = i - pix * g;
    const int y = y0 + pix / p.tw, x = x0 + pix % p.tw;
    if (y < p.H && x < p.W) o[(static_cast<long long>(y) * p.W + x) * D + j] = so[pix * gs + j] / norm;
  }
}

// The launch's geometry for a plan; the same arithmetic as
// correlation_kernel.plan.
struct Geometry {
  int tw, halo_w, halo_h, tiles_x, tiles, groups_x, groups;
  long long smem;
};

Geometry geometry(int H, int W, int steps, int s2, int r, int gx, int gy, int warps) {
  Geometry g;
  g.tw = 4 * r * warps;
  g.halo_w = g.tw + (gx - 1) * s2;
  g.halo_h = kRows + (gy - 1) * s2;
  g.tiles_x = (W + g.tw - 1) / g.tw;
  g.tiles = (H + kRows - 1) / kRows * g.tiles_x;
  g.groups_x = (steps + gx - 1) / gx;
  g.groups = (steps + gy - 1) / gy * g.groups_x;
  const long long staged =
      (static_cast<long long>(kRows) * row_floats(g.tw) + static_cast<long long>(g.halo_h) * row_floats(g.halo_w)) * 4;
  const long long results = static_cast<long long>(kRows) * g.tw * ((gx * gy) | 1) * 4;
  g.smem = staged > results ? staged : results;
  return g;
}

template <int R, int GX, int GY>
cudaError_t launch(const Params& p, int warps, int smem, dim3 grid, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(cost_volume_kernel<R, GX, GY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cost_volume_kernel<R, GX, GY><<<grid, 32 * warps, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int R, int GX>
cudaError_t launch_gy(int gy, const Params& p, int warps, int smem, dim3 grid, cudaStream_t st) {
  switch (gy) {
    case 1: return launch<R, GX, 1>(p, warps, smem, grid, st);
    case 3: return launch<R, GX, 3>(p, warps, smem, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int R>
cudaError_t launch_gx(int gx, int gy, const Params& p, int warps, int smem, dim3 grid, cudaStream_t st) {
  switch (gx) {
    case 1: return launch_gy<R, 1>(gy, p, warps, smem, grid, st);
    case 3: return launch_gy<R, 3>(gy, p, warps, smem, grid, st);
    case 5: return launch_gy<R, 5>(gy, p, warps, smem, grid, st);
    case 7: return launch_gy<R, 7>(gy, p, warps, smem, grid, st);
    case 9: return launch_gy<R, 9>(gy, p, warps, smem, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// f1, f2 (B, H, W, C) f32 on the current device, each dense over (H, W, C)
// with batch strides bs1, bs2 (elements); out (B, H, W, D) f32, contiguous.
// The plan (ops/correlation_kernel.py:plan): r pixels a thread, gx x gy
// displacements a CTA, `threads` threads (one or two warps), `copy` bytes a
// staging copy (16 or 4), `smem` bytes of shared memory and a grid of
// (tiles, groups, B) CTAs; a plan that does not match the shapes, or that
// the kernel was not built for, is refused.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int cost_volume_launch(const void* f1, const void* f2, void* out, long long bs1,
                                  long long bs2, int B, int H, int W, int C, int d, int s2,
                                  int r, int gx, int gy, int threads, int copy, int smem,
                                  int tiles, int groups, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || d < 0 || s2 < 1) return cudaErrorInvalidValue;
  const int steps = 2 * (d / s2) + 1;
  const int warps = threads / 32;
  if (!(r == 1 || (r == 2 && s2 == 1)) || gx > steps || (gx != steps && gy != 1) ||
      threads % 32 != 0 || warps < 1 || warps > kMaxWarps) {
    return cudaErrorInvalidValue;
  }
  const auto aligned = [&](const void* ptr, long long bs) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (B == 1 || bs % 4 == 0);
  };
  if ((copy != 4 && copy != 16) || (copy == 16 && (C % 4 != 0 || !aligned(f1, bs1) || !aligned(f2, bs2)))) {
    return cudaErrorInvalidValue;
  }
  const Geometry g = geometry(H, W, steps, s2, r, gx, gy, warps);
  if (g.smem != smem || smem > kMaxSmem || g.tiles != tiles || g.groups != groups || groups > kMaxGroups) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.f1 = static_cast<const float*>(f1);
  p.f2 = static_cast<const float*>(f2);
  p.out = static_cast<float*>(out);
  p.bs1 = bs1, p.bs2 = bs2;
  p.H = H, p.W = W, p.C = C, p.steps = steps, p.s2 = s2;
  p.tw = g.tw, p.tiles_x = g.tiles_x, p.groups_x = g.groups_x, p.halo_w = g.halo_w, p.halo_h = g.halo_h;
  p.vec = copy == 16;
  const dim3 grid(tiles, groups, B);
  auto st = static_cast<cudaStream_t>(stream);
  return r == 1 ? launch_gx<1>(gx, gy, p, warps, smem, grid, st) : launch_gx<2>(gx, gy, p, warps, smem, grid, st);
}
