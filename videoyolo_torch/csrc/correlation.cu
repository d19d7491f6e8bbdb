// Correlation cost volume (FlowNet / Caffe lineage) for Hopper (sm_90a).
//
// Ports the TPU kernel videoyolo_tpu/ops/pallas_correlation.py:
// correlation_pallas (body _corr_kernel), the JAX package's default for the
// configuration kernel_size=1, stride1=1, multiply.  Plain PyTorch version:
// videoyolo_torch/ops/correlation.py:correlation_plain; Python wrapper and
// work plan: videoyolo_torch/ops/correlation_kernel.py:cost_volume, plan.
// Its adjoint (cost_volume_backward_kernel, below) has no TPU counterpart;
// its wrappers and plan: cost_volume_backward, cost_volume_pair_backward,
// plan_backward in the same module.
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
// zero-fill past C, so the last 4 channels read are zeros beyond C.  P is
// the forward's or the adjoint's parameters (H, W, C, vec).
template <class P>
__device__ __forceinline__ void stage(float* dst, const float* src, int y0, int x0, int rows,
                                      int cols, int c0, const P& p) {
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

// The adjoint of the cost volume: given g = dL/dout (B, H, W, D), the
// gradients of f1 and f2 (B, H, W, C), both gathers, with o_d = (oy, ox)
// the offset of displacement d and every term outside the image zero:
//   gf1[b, y, x, c] = sum_d g[b, y, x, d] * f2[b, y+oy, x+ox, c] / C
//   gf2[b, y, x, c] = sum_d g[b, y-oy, x-ox, d] * f1[b, y-oy, x-ox, c] / C
// The TPU kernel has no backward (the JAX package differentiates the XLA
// form, videoyolo_tpu/ops/correlation.py:64-80); this kernel is the port's
// own, held against ops/correlation_kernel.py:cost_volume_backward_plain.
//
// Bound on an H100 SXM at 700 W (train step, B=16 windows, d=4, D=81): the
// launch must read g, f1 and f2 and write gf1 and gf2 (192 MB at
// 52x52x256): 0.0571 / 0.0275 / 0.0135 ms at 3.35 TB/s at 52x52x256 /
// 26x26x512 / 13x13x1024, against 0.049 / 0.024 / 0.011 ms for the 2 x 81
// multiply-adds an element at 67 TFLOP/s, so bytes bound it.  Each f value
// meets 81 g values: fetched once per displacement, as a first design of
// one thread an element did (2.10 ms at 52x52x256), that is 3.6 GB of f
// reads a gradient.
//
// Design: the forward's, turned round.  The sum runs over displacements,
// not channels, so the channels are independent and C splits into slabs at
// no cost.  One CTA per (image, tile of 8 rows x TW columns, gradient, slab
// of channels), grid (tiles, 2 x slabs, B) for one volume: blockIdx.y % 2
// picks gf1 or gf2, so one launch writes both, and the plan
// (correlation_kernel.plan_backward) cuts C into slabs until the launch
// fills the card.
//  * g staged once per CTA, not once per channel: the tile's 8 x 8 pixels
//    x the displacements, in rows of 8 * dg + 1 floats (dg: the
//    displacements rounded to 4 past a multiple of 8, so that the 16
//    pixels a warp reads lie in distinct banks at the main path's 81).  For
//    gf2 it is staged shifted, g'[p, d] = g[p - o_d, d], zero where p - o_d
//    lies outside the image: a gather of 4-byte copies, as many as of the
//    tile's own g (20.7 KB at 8x8 and d=4).  The unshifted window of g (tile + halo) would copy
//    coalesced but take 83 KB, four times the shared memory of a CTA.
//  * The partner window staged per 16-channel chunk by the forward's
//    stage(): f2 over the tile +- s*stride2 for gf1, f1 over the same window
//    read at the opposite offset for gf2; pixel-major, 16-byte cp.async (or
//    4-byte), rows padded to an odd number of 16-byte units.  Each window
//    pixel comes from device memory (L2) once a chunk per CTA, not once per
//    displacement.
//  * A register tile: lane l takes tile row l % 8, 8 channels (two float4s)
//    and R neighbouring pixels; per displacement row it loads the R + GX - 1
//    window pixels its R pixels reach (stride2 == 1) once and multiplies
//    each by the g of every pixel it serves: at R=2 and GX=9, 20 16-byte
//    and 18 4-byte shared loads (the latter broadcast over the 2 channel
//    lanes of a pixel) for 144 multiply-adds.
//  * Summation order kept: each output element is summed over d = 0 .. D-1
//    in order with fmaf, then divided by C, as the one-thread-an-element
//    kernel and the plain version do; staged zeros take the place of the
//    skipped out-of-image terms, so on finite inputs the result equals that
//    kernel's bit for bit but for the sign of a zero.  gf2 walks its window
//    columns (and rows) backwards, so that each pixel still meets its
//    displacements in order.
//  * Wide displacement grids come in groups of GY rows x GX columns (GY > 1
//    only where GX is a whole row), walked in order inside the CTA, the
//    window and g staged per group; with one group (d <= 4 at stride2 1) g
//    is staged once for all of the slab's chunks.
//  * The pair (`pair`): the Corr layer compares frames a and b with the
//    middle frame m, so one launch takes both volumes' gradients ga, gb and
//    writes the three frames' gradients of the window: gf_a and gf_b as
//    gf1 above (partner m), and gf_m = gf2 of (ga, a) + gf2 of (gb, b), which
//    one CTA computes in two passes, the second added to the first as it is
//    written (the same sum as the two gf2s added after, bit for bit).  Grid
//    (tiles, 4 x slabs, B): a gf_m CTA takes half a slab, so that its two
//    passes are as much work as another CTA's one (with whole slabs, 3
//    roles, the gf_m CTAs ran last and the launch lost 36-41% to two
//    one-volume launches at 26x26x512 and 13x13x1024).  It takes 0.7057 /
//    0.5128 / 0.2509 ms at the three levels against 0.7429 / 0.4742 /
//    0.2587 for two one-volume launches and their add (probe, same call):
//    the launch is a wash; what it saves is autograd's scatter of four frame
//    gradients into zeroed windows.
// R and GX are template arguments, so the accumulators live in registers.
// R is 2 (two warps a CTA) where stride2 == 1, else 1 (four warps); R=4 in
// one warp was an instance and lost at every level: at 38 KB of shared
// memory an SM holds 5 CTAs, so its warps come from the threads of a CTA.
// Measured (H100 80GB HBM3, 700 W limit, B=16, d=4): one volume 0.3494 /
// 0.2268 / 0.1232 ms a launch at 52x52x256 / 26x26x512 / 13x13x1024 with
// the queue full (probe_cost_volume.py), 6.1 / 8.2 / 9.1x the bound,
// against 2.0993 / 0.9904 / 0.4411 for one thread an element in the same
// call; 1.468 ms a window train step over 3 pair launches (chip_smoke.py),
// against 7.05 over 6; the step 67.9 -> 61.0 ms.  What bounds it now: the
// shared-memory pipe, at 0.68 wavefronts a warp's multiply-add (20 16-byte
// and 18 broadcast loads per 144), about 0.2 ms at 52x52x256 on its own,
// and the staging's latency: each CTA waits for its chunk's copies, then
// computes, with 10 warps an SM to cover it.
constexpr int kQuads = 2;            // float4s of channels a thread: 8 of a chunk's 16
constexpr int kMaxBwdThreads = 128;  // 8 rows x 8 column groups (R=1) x 2 channel halves
constexpr int kMaxGridY = 65535;     // roles x slabs

// floats a staged pixel of g takes for n displacements: at least n, and 4
// past a multiple of 8
__host__ __device__ constexpr int g_floats(int n) { return (n + 3) / 8 * 8 + 4; }

// One volume: g, f1, f2 -> gf1, gf2.  The pair: g (ga), g2 (gb), f1 (frame
// a), f2 (the middle frame), f3 (frame b) -> gf1 (gf_a), gf2 (gf_m), gf3
// (gf_b), frames of one (B, 3, H, W, C) window gradient.
struct BackwardParams {
  const float* g;
  const float* g2;
  const float* f1;
  const float* f2;
  const float* f3;
  float* gf1;
  float* gf2;
  float* gf3;
  long long bs1, bs2, bs3;  // batch strides of f1, f2, f3, elements
  long long obs;            // batch stride of the gradients
  int pair;
  int H, W, C, steps, s2;
  int tw, tiles_x, slab, gy, groups_x, groups, win_w, win_h, dg, grow;
  int vec;  // 16-byte copies, else 4-byte ones
};

__device__ __forceinline__ void axpy4(float4& acc, float g, const float4& f) {
  acc.x = fmaf(g, f.x, acc.x);
  acc.y = fmaf(g, f.y, acc.y);
  acc.z = fmaf(g, f.z, acc.z);
  acc.w = fmaf(g, f.w, acc.w);
}

// Stages g of the group's displacements (rows iy0.., columns ix0..) at each
// pixel p of the tile: g[p, d] for gf1, g[p - o_d, d] for gf2 (FLIP); zero
// where that pixel lies outside the image or d outside the grid.
template <int GX, bool FLIP>
__device__ __forceinline__ void stage_g(float* sg, const float* g, int y0, int x0, int iy0, int ix0,
                                        const BackwardParams& p) {
  const int n = p.gy * GX, s = p.steps / 2, D = p.steps * p.steps;
  const int total = kRows * p.tw * n;
  for (int u = threadIdx.x; u < total; u += blockDim.x) {
    const int pix = u / n, j = u - pix * n;
    const int jy = j / GX, jx = j - jy * GX;
    const int ty = pix / p.tw, tx = pix - ty * p.tw;
    const int iy = iy0 + jy, ix = ix0 + jx;
    const int y = y0 + ty - (FLIP ? (iy - s) * p.s2 : 0);
    const int x = x0 + tx - (FLIP ? (ix - s) * p.s2 : 0);
    const bool in = iy < p.steps && ix < p.steps && y >= 0 && y < p.H && x >= 0 && x < p.W;
    copy4(sg + ty * p.grow + tx * p.dg + j,
          in ? g + (static_cast<long long>(y) * p.W + x) * D + iy * p.steps + ix : g, in);
  }
}

// acc[r][q] += g[pixel r, d] * window[pixel r's partner at d] over the
// group's displacements in order: rows jy < ny, columns jx < GX (g is zero
// past the grid).  w: the thread's first pixel and channels in the window
// row of displacement row 0 (gf1) or 0 shifted to the group's last (gf2);
// gs: its first pixel's staged g.
template <int R, int GX, bool FLIP>
__device__ __forceinline__ void accumulate(float4 (&acc)[R][kQuads], const float* w, const float* gs, int ny,
                                           int w_row, const BackwardParams& p) {
#pragma unroll 1
  for (int jy = 0; jy < ny; ++jy) {
    const float* row = w + (FLIP ? p.gy - 1 - jy : jy) * p.s2 * w_row;
    const float* gr = gs + jy * GX;
    if constexpr (R == 1) {
#pragma unroll
      for (int jx = 0; jx < GX; ++jx) {
        const float gv = gr[jx];
        const float* f = row + (FLIP ? GX - 1 - jx : jx) * p.s2 * kChunk;
#pragma unroll
        for (int q = 0; q < kQuads; ++q) axpy4(acc[0][q], gv, load4(f + q * 4));
      }
    } else {
      // stride2 == 1: pixel r at displacement column jx reads window column
      // r + jx (gf1) or r + GX-1-jx (gf2), so each window pixel loaded serves
      // up to R pixels; gf2 walks the columns backwards, so that each pixel
      // meets its displacements in order
#pragma unroll
      for (int i = 0; i < R + GX - 1; ++i) {
        const int k = FLIP ? R + GX - 2 - i : i;
        float4 v[kQuads];
#pragma unroll
        for (int q = 0; q < kQuads; ++q) v[q] = load4(row + k * kChunk + q * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int jw = k - r;
          if (jw >= 0 && jw < GX) {
            const float gv = gr[r * p.dg + (FLIP ? GX - 1 - jw : jw)];
#pragma unroll
            for (int q = 0; q < kQuads; ++q) axpy4(acc[r][q], gv, v[q]);
          }
        }
      }
    }
  }
}

// One CTA's pass over its tile and channels cs0 .. cs1-1 for one volume:
// out = sum_d g x part / C (gf1 from f2, or gf2 from f1 with FLIP), or
// out += that where `add`; g, part and out point at the CTA's image.
template <int R, int GX, bool FLIP>
__device__ __forceinline__ void backward_pass(float* smem, const BackwardParams& p, int cs0, int cs1,
                                              const float* g, const float* part, float* out, bool add) {
  const int w_row = row_floats(p.win_w);
  float* sw = smem;                    // [win_h][win_w][kChunk] + pad: the partner's window
  float* sg = smem + p.win_h * w_row;  // [kRows][tw * dg + 1]: g at the tile's pixels
  const int ty = threadIdx.x % 8;             // tile row
  const int half = (threadIdx.x / 8) % 2;     // channels half*8 .. half*8+7 of a chunk
  const int cx = threadIdx.x / 16 * R;        // first tile column
  const int y0 = (blockIdx.x / p.tiles_x) * kRows;
  const int x0 = (blockIdx.x % p.tiles_x) * p.tw;
  const int s = p.steps / 2;
  const float* wt = sw + ty * w_row + cx * kChunk + half * 4 * kQuads;
  const float* gt = sg + ty * p.grow + cx * p.dg;

  __syncthreads();  // a pass before this one is done with the shared memory
  if (p.groups == 1) stage_g<GX, FLIP>(sg, g, y0, x0, 0, 0, p);  // waited for with the first chunk
  for (int c0 = cs0; c0 < cs1; c0 += kChunk) {
    float4 acc[R][kQuads];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < kQuads; ++q) acc[r][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 1
    for (int grp = 0; grp < p.groups; ++grp) {
      const int iy0 = grp / p.groups_x * p.gy, ix0 = grp % p.groups_x * GX;
      // the window's origin: the group's least offset for gf1, minus its
      // greatest for gf2
      const int wy0 = FLIP ? y0 - (iy0 + p.gy - 1 - s) * p.s2 : y0 + (iy0 - s) * p.s2;
      const int wx0 = FLIP ? x0 - (ix0 + GX - 1 - s) * p.s2 : x0 + (ix0 - s) * p.s2;
      __syncthreads();  // the previous window (and g) consumed
      stage(sw, part, wy0, wx0, p.win_h, p.win_w, c0, p);
      if (p.groups > 1) stage_g<GX, FLIP>(sg, g, y0, x0, iy0, ix0, p);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      accumulate<R, GX, FLIP>(acc, wt, gt, min(p.gy, p.steps - iy0), w_row, p);
    }
    // divided by C on the way out (and added to what the first pass wrote),
    // 16 bytes at a time where C % 4 == 0
    const int y = y0 + ty;
    const float norm = static_cast<float>(p.C);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int x = x0 + cx + r;
      if (y >= p.H || x >= p.W) continue;
      float* o = out + (static_cast<long long>(y) * p.W + x) * p.C;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int c = c0 + half * 4 * kQuads + q * 4;
        float4 a = make_float4(acc[r][q].x / norm, acc[r][q].y / norm, acc[r][q].z / norm, acc[r][q].w / norm);
        if (p.C % 4 == 0 && c < cs1) {
          float4* o4 = reinterpret_cast<float4*>(o + c);
          if (add) {
            const float4 prev = *o4;
            a = make_float4(prev.x + a.x, prev.y + a.y, prev.z + a.z, prev.w + a.w);
          }
          *o4 = a;
        } else {
          const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (c + i < cs1) o[c + i] = add ? o[c + i] + v[i] : v[i];
          }
        }
      }
    }
  }
}

// at least one CTA an SM, as the forward's instances.  blockIdx.y: the
// slab and the role, the gradient the CTA writes: gf1 or gf2 of one volume
// (2 roles); gf_a, gf_b, or gf_m over the first or the second half of the
// slab (4 roles: a gf_m CTA makes two passes over half the channels, as much
// work as the others)
template <int R, int GX>
__global__ void __launch_bounds__(kMaxBwdThreads, 1) cost_volume_backward_kernel(const BackwardParams p) {
  extern __shared__ __align__(16) float smem[];
  const int roles = p.pair ? 4 : 2, role = blockIdx.y % roles;
  const bool flip = role == 1 + p.pair || role == 3;  // gf2, gf_m
  int cs0 = blockIdx.y / roles * p.slab, cs1 = min(p.C, cs0 + p.slab);
  if (p.pair && flip) {
    const int half = (p.slab / 2 + kChunk - 1) / kChunk * kChunk;
    cs0 += (role - 2) * half;
    cs1 = min(cs1, cs0 + half);
    if (cs0 >= cs1) return;  // a slab of one chunk has no second half
  }
  const long long b = blockIdx.z, gs = static_cast<long long>(p.H) * p.W * p.steps * p.steps;
  if (!flip) {
    // gf1, gf_a, gf_b: the pixel's own g against the frame it was compared with
    backward_pass<R, GX, false>(smem, p, cs0, cs1, (role ? p.g2 : p.g) + b * gs, p.f2 + b * p.bs2,
                                (role ? p.gf3 : p.gf1) + b * p.obs, false);
  } else {
    // gf2 of each volume, the second added to the first
    for (int k = 0; k < (p.pair ? 2 : 1); ++k) {
      backward_pass<R, GX, true>(smem, p, cs0, cs1, (k ? p.g2 : p.g) + b * gs,
                                 k ? p.f3 + b * p.bs3 : p.f1 + b * p.bs1, p.gf2 + b * p.obs, k > 0);
    }
  }
}

// The adjoint launch's geometry for a plan; the same arithmetic as
// correlation_kernel.plan_backward.
struct BackwardGeometry {
  int tw, win_w, win_h, tiles_x, tiles, groups_x, groups, dg, grow, slabs;
  long long smem;
};

BackwardGeometry backward_geometry(int H, int W, int C, int steps, int s2, int r, int cg, int gx, int gy,
                                   int slab) {
  BackwardGeometry g;
  g.tw = r * cg;
  g.win_w = g.tw + (gx - 1) * s2;
  g.win_h = kRows + (gy - 1) * s2;
  g.tiles_x = (W + g.tw - 1) / g.tw;
  g.tiles = (H + kRows - 1) / kRows * g.tiles_x;
  g.groups_x = (steps + gx - 1) / gx;
  g.groups = (steps + gy - 1) / gy * g.groups_x;
  g.dg = g_floats(gx * gy);
  g.grow = g.tw * g.dg + 1;
  g.slabs = (C + slab - 1) / slab;
  g.smem = (static_cast<long long>(g.win_h) * row_floats(g.win_w) + static_cast<long long>(kRows) * g.grow) * 4;
  return g;
}

template <int R, int GX>
cudaError_t launch_backward(const BackwardParams& p, int threads, int smem, dim3 grid, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(cost_volume_backward_kernel<R, GX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cost_volume_backward_kernel<R, GX><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_backward_gx(int gx, const BackwardParams& p, int threads, int smem, dim3 grid, cudaStream_t st) {
  switch (gx) {
    case 1: return launch_backward<R, 1>(p, threads, smem, grid, st);
    case 3: return launch_backward<R, 3>(p, threads, smem, grid, st);
    case 5: return launch_backward<R, 5>(p, threads, smem, grid, st);
    case 7: return launch_backward<R, 7>(p, threads, smem, grid, st);
    case 9: return launch_backward<R, 9>(p, threads, smem, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One volume (pair == 0): g (B, H, W, D) f32, contiguous; f1, f2 (B, H, W,
// C) f32, each dense over (H, W, C) with batch strides bs1, bs2 (elements);
// gf1, gf2 (B, H, W, C) f32, contiguous, written whole; g2, f3, gf3 unused.
// The pair (pair == 1): g, g2 the gradients of the volumes (f1, f2) and
// (f3, f2); gf1, gf2, gf3 frames 0, 1, 2 of a contiguous (B, 3, H, W, C)
// window gradient, written whole.  The plan
// (ops/correlation_kernel.py:plan_backward): r pixels a thread, gx x gy
// displacements a group, slab channels a CTA, `threads` threads (8 rows x
// threads / 16 column groups x 2 channel halves), `copy` bytes a staging
// copy (16 or 4), `smem` bytes of shared memory and a grid of (tiles, 2 or
// 4 x slabs, B) CTAs; a plan that does not match the shapes, or that the
// kernel was not built for, is refused.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int cost_volume_backward_launch(const void* g, const void* g2, const void* f1, const void* f2,
                                           const void* f3, void* gf1, void* gf2, void* gf3, long long bs1,
                                           long long bs2, long long bs3, int B, int H, int W, int C, int d,
                                           int s2, int pair, int r, int gx, int gy, int slab, int threads,
                                           int copy, int smem, int tiles, int slabs, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || d < 0 || s2 < 1 || (pair != 0 && pair != 1)) {
    return cudaErrorInvalidValue;
  }
  const int steps = 2 * (d / s2) + 1;
  if (!(r == 1 || (r == 2 && s2 == 1)) || threads % 32 != 0 || threads < 32 ||
      threads > kMaxBwdThreads || gx > steps || gy < 1 || gy > steps || (gy != 1 && gx != steps) ||
      slab < kChunk || slab % kChunk != 0) {
    return cudaErrorInvalidValue;
  }
  const auto aligned = [&](const void* ptr, long long bs) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (B == 1 || bs % 4 == 0);
  };
  if ((copy != 4 && copy != 16) ||
      (copy == 16 && (C % 4 != 0 || !aligned(f1, bs1) || !aligned(f2, bs2) || (pair && !aligned(f3, bs3))))) {
    return cudaErrorInvalidValue;
  }
  const BackwardGeometry geo = backward_geometry(H, W, C, steps, s2, r, threads / 16, gx, gy, slab);
  if (geo.smem != smem || smem > kMaxSmem || geo.tiles != tiles || geo.slabs != slabs ||
      (2 + 2 * pair) * slabs > kMaxGridY) {
    return cudaErrorInvalidValue;
  }
  BackwardParams p;
  p.g = static_cast<const float*>(g);
  p.g2 = static_cast<const float*>(pair ? g2 : g);
  p.f1 = static_cast<const float*>(f1);
  p.f2 = static_cast<const float*>(f2);
  p.f3 = static_cast<const float*>(pair ? f3 : f1);
  p.gf1 = static_cast<float*>(gf1);
  p.gf2 = static_cast<float*>(gf2);
  p.gf3 = static_cast<float*>(pair ? gf3 : gf1);
  p.bs1 = bs1, p.bs2 = bs2, p.bs3 = pair ? bs3 : bs1;
  p.obs = static_cast<long long>(1 + 2 * pair) * H * W * C;
  p.pair = pair;
  p.H = H, p.W = W, p.C = C, p.steps = steps, p.s2 = s2;
  p.tw = geo.tw, p.tiles_x = geo.tiles_x, p.slab = slab, p.gy = gy, p.groups_x = geo.groups_x;
  p.groups = geo.groups, p.win_w = geo.win_w, p.win_h = geo.win_h, p.dg = geo.dg, p.grow = geo.grow;
  p.vec = copy == 16;
  const dim3 grid(tiles, (2 + 2 * pair) * slabs, B);
  auto st = static_cast<cudaStream_t>(stream);
  return r == 1 ? launch_backward_gx<1>(gx, p, threads, smem, grid, st)
                : launch_backward_gx<2>(gx, p, threads, smem, grid, st);
}

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
