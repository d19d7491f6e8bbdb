// Correlation cost volume (FlowNet / Caffe lineage) for Hopper (sm_90a).
//
// Ports the TPU kernel videoyolo_tpu/ops/pallas_correlation.py:
// correlation_pallas (body _corr_kernel), the JAX package's default for the
// configuration kernel_size=1, stride1=1, multiply.  Plain PyTorch version:
// videoyolo_torch/ops/correlation.py:correlation_plain; Python wrapper:
// videoyolo_torch/ops/correlation_kernel.py:cost_volume.
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
// nearly balanced (about 16 FLOP per byte), so a kernel that re-reads f2
// from device memory for each of the 81 displacements is far from both.
//
// Design: one CTA per (image, 8x32 tile of output pixels, group of
// displacements); one thread per output pixel.
//  * f1's tile and the f2 window the group's displacements reach (the tile
//    plus a halo) are staged in shared memory, channel-major, 32 channels at
//    a time: lane = channel, so each warp reads 128 contiguous bytes of a
//    pixel and the staging needs no index division.  The copies are
//    asynchronous (cp.async, zero-filled outside the image), so a warp has
//    all of its chunk's copies in flight at once and holds no registers for
//    them.  Each input value is read from device memory once per group, not
//    once per displacement.  The main path's 81 displacements make 3 groups
//    of 27 (3 dy rows each); the chunk takes 84 KB of shared memory, so two
//    CTAs fit an SM.
//  * Each thread keeps one f32 accumulator per displacement of its group in
//    registers (NACC, a template argument; the unused ones add zeros) and the
//    group's shared-memory offsets beside them.  A warp is one tile row of
//    32 consecutive pixels, so for every displacement the warp reads 32
//    consecutive words of the halo: no bank conflicts.  Plane strides are odd,
//    so the staging stores (lanes on consecutive channels) do not conflict
//    either.
//  * The results go through shared memory and leave as runs of the group's
//    contiguous displacements per pixel.
//  * The ragged edges (H, W not multiples of the tile, any C, the halo
//    outside the image) are masked in the kernel: no padding of the inputs.
// What bounds it now (H100 80GB HBM3, 700 W limit, chip_smoke.py: 0.676 /
// 0.385 / 0.477 ms at the three levels, 11-35x the bound): one shared-memory
// load and one address computation per multiply-add, so the load/store unit
// sets the pace, not device memory or the FMA pipes; the staging is not
// overlapped with the compute except across the two CTAs of an SM; and at
// 13x13 a tile keeps 13 of its 32 columns busy.  Next steps: a register tile
// over neighbouring pixels (which share f2 values across dx and dy), double
// buffering of the chunks, and a split over C for the small levels.
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;                 // output columns per CTA: one warp per tile row
constexpr int kTileH = 8;                  // output rows per CTA
constexpr int kThreads = kTileW * kTileH;  // one thread per output pixel of the tile
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // channels staged at a time: one per lane
constexpr int kF1Plane = kThreads + 1;     // odd plane stride of the staged f1 tile
constexpr int kMaxSmem = 112 * 1024;       // two CTAs per SM
constexpr int kMaxAcc = 32;

__host__ __device__ inline int odd(int n) { return n | 1; }

// one float from device to shared memory, asynchronously; zero when !valid
// (no bytes are read then; src must still be a device address)
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

template <int NACC>
__global__ void __launch_bounds__(kThreads)
cost_volume_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, long long bs1, long long bs2, int H, int W,
                   int C, int steps, int s2, int gx, int gy, int groups_x, int halo_w,
                   int halo_plane) {
  extern __shared__ float smem[];
  float* s1 = smem;                        // [kChunk][kF1Plane]: f1 tile, channel-major
  float* sf2 = smem + kChunk * kF1Plane;   // [kChunk][halo_plane]: f2 halo rows of halo_w
  __shared__ int disp[kMaxAcc];            // output channel of each displacement of the group

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = tid % kTileW, ty = tid / kTileW;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  // this CTA's displacements: rows iy0.. and columns ix0.. of the grid
  const int iy0 = (blockIdx.y / groups_x) * gy;
  const int ix0 = (blockIdx.y % groups_x) * gx;
  const int ny = min(gy, steps - iy0), nx = min(gx, steps - ix0);
  const int g = ny * nx;
  const int s = steps / 2;
  // the f2 window: pixel (y0+ty, x0+tx) at displacement (iy0+jy, ix0+jx)
  // reads halo row ty + jy*s2, column tx + jx*s2
  const int hy0 = y0 + (iy0 - s) * s2;
  const int hx0 = x0 + (ix0 - s) * s2;
  const int halo_h = kTileH + (ny - 1) * s2;
  const float* a = f1 + static_cast<long long>(blockIdx.z) * bs1;
  const float* bm = f2 + static_cast<long long>(blockIdx.z) * bs2;
  if (tid < g) disp[tid] = (iy0 + tid / nx) * steps + ix0 + tid % nx;

  int off[NACC];
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    off[j] = j < g ? (j / nx) * s2 * halo_w + (j % nx) * s2 : 0;
    acc[j] = 0.f;
  }
  const int base = ty * halo_w + tx;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cn = min(kChunk, C - c0);
    __syncthreads();  // the previous chunk is consumed
    if (lane < cn) {
      const int c = c0 + lane;
      for (int p = warp; p < kThreads; p += kWarps) {
        const int y = y0 + p / kTileW, x = x0 + p % kTileW;
        const bool in = y < H && x < W;
        copy_async(s1 + lane * kF1Plane + p,
                   in ? a + (static_cast<long long>(y) * W + x) * C + c : a, in);
      }
      for (int r = 0; r < halo_h; ++r) {
        const int y = hy0 + r;
        const bool row_in = y >= 0 && y < H;
        float* dst = sf2 + lane * halo_plane + r * halo_w;
        for (int q = warp; q < halo_w; q += kWarps) {
          const int x = hx0 + q;
          const bool in = row_in && x >= 0 && x < W;
          copy_async(dst + q, in ? bm + (static_cast<long long>(y) * W + x) * C + c : bm, in);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      const float v = s1[c * kF1Plane + tid];
      const float* row = sf2 + c * halo_plane + base;
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] = fmaf(v, row[off[j]], acc[j]);
    }
  }

  // stage the results, then write each pixel's run of displacements
  __syncthreads();
  const int gs = odd(g);
  float* so = smem;  // [kThreads][gs]
  const float norm = static_cast<float>(C);
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    if (j < g) so[tid * gs + j] = acc[j] / norm;
  }
  __syncthreads();
  const int D = steps * steps;
  float* o = out + static_cast<long long>(blockIdx.z) * H * W * D;
  for (int p = warp; p < kThreads; p += kWarps) {
    const int y = y0 + p / kTileW, x = x0 + p % kTileW;
    if (y >= H || x >= W) continue;
    float* op = o + (static_cast<long long>(y) * W + x) * D;
    for (int j = lane; j < g; j += 32) op[disp[j]] = so[p * gs + j];
  }
}

template <int NACC>
cudaError_t launch(const float* f1, const float* f2, float* out, long long bs1, long long bs2,
                   int B, int H, int W, int C, int steps, int s2, int gx, int gy,
                   cudaStream_t stream) {
  const int halo_w = kTileW + (gx - 1) * s2;
  const int halo_plane = odd((kTileH + (gy - 1) * s2) * halo_w);
  const size_t in_bytes = static_cast<size_t>(kChunk) * (kF1Plane + halo_plane) * sizeof(float);
  const size_t out_bytes = static_cast<size_t>(kThreads) * odd(gx * gy) * sizeof(float);
  const size_t smem = in_bytes > out_bytes ? in_bytes : out_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cost_volume_kernel<NACC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups_x = (steps + gx - 1) / gx;
  const int groups_y = (steps + gy - 1) / gy;
  const dim3 grid(((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW),
                  groups_y * groups_x, B);
  cost_volume_kernel<NACC><<<grid, kThreads, smem, stream>>>(
      f1, f2, out, bs1, bs2, H, W, C, steps, s2, gx, gy, groups_x, halo_w, halo_plane);
  return cudaGetLastError();
}

}  // namespace

// f1, f2 (B, H, W, C) f32 on the current device, each dense over (H, W, C)
// with batch strides bs1, bs2 (elements); out (B, H, W, D) f32, contiguous.
// The plan (gx x gy displacements per CTA, nacc accumulators >= gx*gy)
// comes from the wrapper (ops/correlation_kernel.py:plan).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int cost_volume_launch(const void* f1, const void* f2, void* out, long long bs1,
                                  long long bs2, int B, int H, int W, int C, int d, int s2,
                                  int gx, int gy, int nacc, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || d < 0 || s2 < 1) {
    return cudaErrorInvalidValue;
  }
  const int steps = 2 * (d / s2) + 1;
  if (gx < 1 || gx > steps || gy < 1 || gy > steps || gx * gy > nacc || nacc > kMaxAcc) {
    return cudaErrorInvalidValue;
  }
  const auto* a = static_cast<const float*>(f1);
  const auto* b = static_cast<const float*>(f2);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (nacc) {
    case 1: return launch<1>(a, b, o, bs1, bs2, B, H, W, C, steps, s2, gx, gy, st);
    case 4: return launch<4>(a, b, o, bs1, bs2, B, H, W, C, steps, s2, gx, gy, st);
    case 9: return launch<9>(a, b, o, bs1, bs2, B, H, W, C, steps, s2, gx, gy, st);
    case 16: return launch<16>(a, b, o, bs1, bs2, B, H, W, C, steps, s2, gx, gy, st);
    case 21: return launch<21>(a, b, o, bs1, bs2, B, H, W, C, steps, s2, gx, gy, st);
    case 25: return launch<25>(a, b, o, bs1, bs2, B, H, W, C, steps, s2, gx, gy, st);
    case 27: return launch<27>(a, b, o, bs1, bs2, B, H, W, C, steps, s2, gx, gy, st);
    case 32: return launch<32>(a, b, o, bs1, bs2, B, H, W, C, steps, s2, gx, gy, st);
    default: return cudaErrorInvalidValue;
  }
}
