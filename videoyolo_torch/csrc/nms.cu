// Greedy class-aware NMS over score-sorted candidates, for Hopper (sm_90a).
//
// Ports the TPU kernel videoyolo_tpu/ops/pallas_nms.py:nms_scan_pallas (body
// _nms_kernel), to whose keep mask it is bit-equal.  On the JAX package's
// main path that kernel is off: there the greedy scan runs as XLA's loop in
// videoyolo_tpu/ops/nms.py:_nms_single, followed by the front-pack (argsort
// of ~keep); this kernel does the scan and the pack both.  Plain PyTorch
// version: videoyolo_torch/ops/nms.py:nms_greedy_plain; Python wrapper:
// videoyolo_torch/ops/nms_kernel.py:nms_greedy.
//
// What it computes, per image b, over K rows (id, score, x1, y1, x2, y2)
// already sorted by descending score:
//   keep0[j]       = score[j] > valid_thresh && id[j] >= 0
//   suppress[i][j] = j > i && iou(i, j) > overlap_thresh
//                    && (force_suppress || id[i] == id[j])
//   greedy: for i in 0..K-1, if keep[i]: keep &= ~suppress[i]
//   out: the kept rows, in order, in the first slots of M rows; -1 rows after.
//
// Bound on an H100 (main path B=128, K=400, M=100): the kernel reads
// 128*400*6*4 B = 1.2 MB and writes 0.3 MB of packed rows, under 1 us at
// 3.35 TB/s; the (B, K) keep mask (0.2 MB) is written only when asked for,
// and the main path does not ask.  The IoU work is at most K(K-1)/2
// pairs per image, about 10 M pair evaluations in all, and only the
// same-class ones in the class-aware mode.  Neither is the limit: the greedy
// scan is a chain of up to K dependent steps per image, so the kernel is
// bound by latency.
//
// Design:
//  * One CTA per image (B=128 fills 128 of the 132 SMs).  The candidates go
//    to shared memory as columns; the K x ceil(K/32) suppress bitmask (upper
//    triangle only; 20.8 KB at K=400, 128 KB at K=1024) is built there by
//    all threads, lanes of a warp on consecutive rows i of one 32-column
//    word, so the column reads broadcast.
//  * The greedy scan runs in one warp: lane w holds keep word w.  The warp
//    walks the set bits of each keep word in order (a cleared bit costs
//    nothing), reading the current word from its lane with __shfl_sync; for
//    each kept row i every lane clears its word with row i of the mask.
//  * The pack is fused: a popcount prefix over the keep words gives each
//    kept row its output slot, which replaces the argsort.
//
// Exactness: the keep mask must equal the plain version's bit for bit.  The
// IoU follows the plain version's order of operations with round-to-nearest
// intrinsics, and the library is built with -fmad=false and without
// --use_fast_math, so no FMA contraction or approximate division can flip an
// `iou > overlap_thresh` test.  Inputs are finite (fmaxf and jnp.maximum
// differ only on NaN).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;
constexpr int kMaxWords = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float* __restrict__ dets, float* __restrict__ out,
                  int* __restrict__ keep_out, int K, int M,
                  float overlap_thresh, float valid_thresh, int force_suppress) {
  extern __shared__ float smem[];
  __shared__ uint32_t keep_words[kMaxWords];
  __shared__ int word_offset[kMaxWords];
  __shared__ int total_kept;

  const int W = (K + 31) >> 5;
  float* x1 = smem;
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* area = y2 + K;
  float* cls = area + K;
  uint32_t* mask = reinterpret_cast<uint32_t*>(cls + K);  // [K][W]

  const float* d = dets + static_cast<size_t>(blockIdx.x) * K * 6;

  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const float* r = d + j * 6;
    const float bx1 = r[2], by1 = r[3], bx2 = r[4], by2 = r[5];
    cls[j] = r[0];
    x1[j] = bx1;
    y1[j] = by1;
    x2[j] = bx2;
    y2[j] = by2;
    area[j] = __fmul_rn(fmaxf(__fsub_rn(bx2, bx1), 0.f), fmaxf(__fsub_rn(by2, by1), 0.f));
  }
  __syncthreads();

  // suppress bitmask: item = (word w, row i), rows fastest
  for (int item = threadIdx.x; item < K * W; item += blockDim.x) {
    const int w = item / K;
    const int i = item - w * K;
    const int j0 = w << 5;
    uint32_t bits = 0;
    if (j0 + 31 > i) {
      const float ax1 = x1[i], ay1 = y1[i], ax2 = x2[i], ay2 = y2[i];
      const float ai = area[i], ci = cls[i];
      const int jhi = min(j0 + 32, K);
      for (int j = max(j0, i + 1); j < jhi; ++j) {
        if (!force_suppress && cls[j] != ci) continue;
        const float iw = fmaxf(__fsub_rn(fminf(ax2, x2[j]), fmaxf(ax1, x1[j])), 0.f);
        const float ih = fmaxf(__fsub_rn(fminf(ay2, y2[j]), fmaxf(ay1, y1[j])), 0.f);
        const float inter = __fmul_rn(iw, ih);
        // 0 / max(union, eps) is +0 exactly: skip the division
        const float iou = inter > 0.f
            ? __fdiv_rn(inter, fmaxf(__fsub_rn(__fadd_rn(ai, area[j]), inter), 1e-15f))
            : 0.f;
        if (iou > overlap_thresh) bits |= 1u << (j - j0);
      }
    }
    mask[i * W + w] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t keep = 0;
    if (lane < W) {
      for (int bit = 0; bit < 32; ++bit) {
        const int j = (lane << 5) + bit;
        if (j < K && d[j * 6 + 1] > valid_thresh && cls[j] >= 0.f) keep |= 1u << bit;
      }
    }
    for (int wi = 0; wi < W; ++wi) {
      // cur is warp-uniform: the set bits of word wi not yet visited
      uint32_t cur = __shfl_sync(kFull, keep, wi);
      while (cur) {
        const int bit = __ffs(cur) - 1;
        const int i = (wi << 5) + bit;  // still kept: every earlier row was applied
        if (lane < W) keep &= ~mask[i * W + lane];
        cur = __shfl_sync(kFull, keep, wi) & ~((2u << bit) - 1u);
      }
    }
    const int count = __popc(keep);
    int incl = count;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < W) {
      keep_words[lane] = keep;
      word_offset[lane] = incl - count;
    }
    if (lane == 31) total_kept = incl;
  }
  __syncthreads();

  int* kp = keep_out ? keep_out + static_cast<size_t>(blockIdx.x) * K : nullptr;
  float* o = out + static_cast<size_t>(blockIdx.x) * M * 6;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const uint32_t word = keep_words[j >> 5];
    const int bit = j & 31;
    const int kept = (word >> bit) & 1u;
    if (kp) kp[j] = kept;
    if (kept) {
      const int slot = word_offset[j >> 5] + __popc(word & ((1u << bit) - 1u));
      if (slot < M) {
        for (int c = 0; c < 6; ++c) o[slot * 6 + c] = d[j * 6 + c];
      }
    }
  }
  for (int s = total_kept + threadIdx.x; s < M; s += blockDim.x) {
    for (int c = 0; c < 6; ++c) o[s * 6 + c] = -1.f;
  }
}

}  // namespace

// dets (B, K, 6) f32, out (B, M, 6) f32, keep (B, K) i32 or null (not
// written), all contiguous on the current device.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int nms_greedy_launch(const void* dets, void* out, void* keep, int B, int K,
                                 int M, float overlap_thresh, float valid_thresh,
                                 int force_suppress, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK || M < 1 || M > K) return cudaErrorInvalidValue;
  const int W = (K + 31) / 32;
  const size_t smem = static_cast<size_t>(K) * 6 * sizeof(float) +
                      static_cast<size_t>(K) * W * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_greedy_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dets), static_cast<float*>(out), static_cast<int*>(keep), K, M,
      overlap_thresh, valid_thresh, force_suppress);
  return cudaGetLastError();
}
