// Greedy class-aware NMS over score-sorted candidates, for Hopper (sm_90a).
//
// Ports the TPU kernel videoyolo_tpu/ops/pallas_nms.py:nms_scan_pallas (body
// _nms_kernel), to whose keep mask it is bit-equal.  On the JAX package's
// main path that kernel is off: there the greedy scan runs as XLA's loop in
// videoyolo_tpu/ops/nms.py:_nms_single, followed by the front-pack (argsort
// of ~keep); these kernels do the scan and the pack both.  Plain PyTorch
// version: videoyolo_torch/ops/nms.py:nms_greedy_plain; Python wrapper and
// plan: videoyolo_torch/ops/nms_kernel.py:nms_greedy, plan.
//
// What it computes, per image b, over K rows (id, score, x1, y1, x2, y2)
// already sorted by descending score:
//   keep0[j]       = score[j] > valid_thresh && id[j] >= 0
//   suppress[i][j] = j > i && iou(i, j) > overlap_thresh
//                    && (force_suppress || id[i] == id[j])
//   greedy: for i in 0..K-1, if keep[i]: keep &= ~suppress[i]
//   out: the kept rows, in order, in the first slots of M rows; -1 rows after.
// Any K: the suppress rows live in a workspace in device memory, not in one
// CTA's shared memory, so only the workspace's size bounds K (the wrapper's
// limit).
//
// Bound on an H100 (main path B=128, K=400, M=100): the kernels must read
// 128*400*6*4 B = 1.2 MB and write 0.3 MB of packed rows, under 1 us at
// 3.35 TB/s; the (B, K) keep mask (0.2 MB) is written only when asked for,
// and the main path does not ask.  The IoU work is at most K(K-1)/2 pairs
// per image, about 10 M pair evaluations in all, and only the same-class
// ones in the class-aware mode.  Neither is the limit: the greedy scan is a
// chain of up to K dependent steps per image, and the call is two launches,
// so the kernels are bound by latency.
// Measured (H100 80GB HBM3, 700 W limit, chip_smoke.py, K=400): a call takes
// 0.050 ms on the device at B=128 (mask 0.028 + scan 0.021) and 0.028 at B=1
// (0.008 + 0.020), against 0.090 and 0.086 for one CTA an image building a
// 32-bit bitmask in shared memory and scanning it in one warp.  The mask
// launch is bound by the IoU loop's instructions at B=128; the scan takes
// about 2.7 us a 64-row block.  One thread a row (64 a mask CTA) was slower:
// 0.0324 against 0.0283 ms at B=128, 0.0127 against 0.0077 at B=1, where 28
// CTAs hold too few warps to hide the IoU's latency.
//
// Design, two launches:
//  * nms_mask_kernel builds the suppress rows across the card: one CTA per
//    (image, 64-row block rb, 64-column block cb >= rb), the upper triangle
//    of 64x64 tiles only, W(W+1)/2 CTAs an image with W = ceil(K/64).  The
//    column block's boxes are staged in shared memory as columns; two of the
//    CTA's 128 threads take row i, each building one 32-bit half of its word
//    cb.  The words go to the workspace mask[b][i][w] (B, K, W) uint64, 2.9
//    MB at the main path, which stays in L2.  Bits j <= i of a diagonal tile,
//    and columns past K, stay 0; the words below the diagonal (w < i / 64)
//    are never written nor read.
//  * nms_scan_kernel, one CTA per image, walks it one 64-row block at a time.
//    The "alive" words (candidates not yet suppressed, from the valid bits,
//    32 rows a ballot) live in shared memory.  For block rb, thread 0
//    resolves the block's keep word serially against the block's 64 diagonal
//    words, held in registers (prefetched during the previous block): 64
//    steps of predicated bit operations, no load or shuffle on the chain.
//    Then every thread takes a later word w (several threads a word when few
//    words are left) and ORs the kept rows' words w, 8 loads in flight at a
//    time, clearing them from alive[w] with a shared atomic.  The pack takes
//    a popcount prefix over the W keep words (a CTA-wide scan), which gives
//    each kept row its output slot in place of the argsort.
//
// Exactness: the keep mask must equal the plain version's bit for bit.  The
// IoU follows the plain version's order of operations with round-to-nearest
// intrinsics, and the library is built with -fmad=false and without
// --use_fast_math, so no FMA contraction or approximate division can flip an
// `iou > overlap_thresh` test.  Inputs are finite (fmaxf and torch.clamp
// differ only on NaN).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;         // rows and columns of a mask tile: one 64-bit word
constexpr int kMaskThreads = 2 * kBlock;  // two a row, a 32-bit half each
constexpr int kScanThreads = 128;
constexpr int kBatch = 8;          // suppress words a scan thread has in flight
constexpr int kMaxBatch = 65535;   // the mask grid's y extent
constexpr int kMaxScanSmem = 48 * 1024;  // no opt-in: the wrapper's workspace limit keeps K far below
constexpr unsigned kFull = 0xffffffffu;

// mask tiles of the row blocks before r: W + (W - 1) + ... + (W - r + 1)
__device__ __forceinline__ long long tile_start(long long r, long long W) {
  return r * W - r * (r - 1) / 2;
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ dets, uint64_t* __restrict__ mask, int K, int W,
                float overlap_thresh, int force_suppress) {
  __shared__ float sx1[kBlock], sy1[kBlock], sx2[kBlock], sy2[kBlock], sarea[kBlock], scls[kBlock];

  // the tile (rb, cb), cb >= rb, from the CTA's index in the upper triangle
  const long long tile = blockIdx.x;
  const double w2 = 2.0 * W + 1.0;
  int rb = static_cast<int>((w2 - sqrt(w2 * w2 - 8.0 * static_cast<double>(tile))) * 0.5);
  rb = max(0, min(rb, W - 1));
  while (rb > 0 && tile_start(rb, W) > tile) --rb;
  while (rb + 1 < W && tile_start(rb + 1, W) <= tile) ++rb;
  const int cb = rb + static_cast<int>(tile - tile_start(rb, W));
  const float* d = dets + static_cast<size_t>(blockIdx.y) * K * 6;

  const int t = threadIdx.x % kBlock;  // the row in the tile
  if (threadIdx.x < kBlock) {
    const int j = cb * kBlock + t;
    if (j < K) {
      const float* r = d + static_cast<size_t>(j) * 6;
      const float bx1 = r[2], by1 = r[3], bx2 = r[4], by2 = r[5];
      scls[t] = r[0];
      sx1[t] = bx1;
      sy1[t] = by1;
      sx2[t] = bx2;
      sy2[t] = by2;
      sarea[t] = box_area(bx1, by1, bx2, by2);
    }
  }
  __syncthreads();

  const int i = rb * kBlock + t;
  if (i >= K) return;
  const float* r = d + static_cast<size_t>(i) * 6;
  const float ci = r[0], ax1 = r[2], ay1 = r[3], ax2 = r[4], ay2 = r[5];
  const float ai = box_area(ax1, ay1, ax2, ay2);
  const int c0 = static_cast<int>(threadIdx.x / kBlock) * 32;  // this thread's half
  const int c1 = min(c0 + 32, K - cb * kBlock);
  const int first = cb == rb ? t + 1 : 0;  // the diagonal tile: j > i only
  uint32_t bits = 0;
  // c runs alike in every lane, so the staged columns are read as broadcasts
  for (int c = c0; c < c1; ++c) {
    if (c < first || (!force_suppress && scls[c] != ci)) continue;
    const float iw = fmaxf(__fsub_rn(fminf(ax2, sx2[c]), fmaxf(ax1, sx1[c])), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(ay2, sy2[c]), fmaxf(ay1, sy1[c])), 0.f);
    const float inter = __fmul_rn(iw, ih);
    // 0 / max(union, eps) is +0 exactly: skip the division
    const float iou = inter > 0.f
        ? __fdiv_rn(inter, fmaxf(__fsub_rn(__fadd_rn(ai, sarea[c]), inter), 1e-15f))
        : 0.f;
    if (iou > overlap_thresh) bits |= 1u << (c - c0);
  }
  // the low half (columns 0-31) first: the words are little-endian
  uint64_t* word = mask + (static_cast<size_t>(blockIdx.y) * K + i) * W + cb;
  reinterpret_cast<uint32_t*>(word)[c0 / 32] = bits;
}

// thread 0's copy of block rb's diagonal words, in halves: dlo[t] the low
// half of row t's word (rows t >= 32 have none: their bits j <= i are 0)
__device__ __forceinline__ void load_diagonal(const uint64_t* __restrict__ mk, int rb, int K, int W,
                                              uint32_t (&dlo)[32], uint32_t (&dhi)[kBlock]) {
#pragma unroll
  for (int t = 0; t < kBlock; ++t) {
    const int i = rb * kBlock + t;
    const uint64_t w = i < K ? mk[static_cast<size_t>(i) * W + rb] : 0ull;
    if (t < 32) dlo[t] = static_cast<uint32_t>(w);
    dhi[t] = static_cast<uint32_t>(w >> 32);
  }
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ dets, const uint64_t* __restrict__ mask,
                float* __restrict__ out, int* __restrict__ keep_out, int K, int W, int M,
                float valid_thresh) {
  extern __shared__ uint64_t alive[];                // [W]: not yet suppressed; at the end, kept
  int* offset = reinterpret_cast<int*>(alive + W);   // [W]: kept rows before each word
  __shared__ uint64_t block_keep;
  __shared__ int warp_total[kScanThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* d = dets + static_cast<size_t>(blockIdx.x) * K * 6;
  const uint64_t* mk = mask + static_cast<size_t>(blockIdx.x) * K * W;

  uint32_t dlo[32], dhi[kBlock];
  if (tid == 0) load_diagonal(mk, 0, K, W, dlo, dhi);

  // the candidates, 32 rows a ballot into the halves of the alive words
  for (int base = warp * 32; base < W * kBlock; base += kScanThreads) {
    const int j = base + lane;
    const bool valid = j < K && d[static_cast<size_t>(j) * 6 + 1] > valid_thresh &&
                       d[static_cast<size_t>(j) * 6] >= 0.f;
    const unsigned bits = __ballot_sync(kFull, valid);
    if (lane == 0) reinterpret_cast<uint32_t*>(alive)[base >> 5] = bits;
  }
  __syncthreads();

  for (int rb = 0; rb < W; ++rb) {
    if (tid == 0) {
      // every row before the block is resolved: alive[rb] holds the block's
      // rows that no kept row before it suppresses
      const uint64_t cand = alive[rb];
      uint32_t lo = static_cast<uint32_t>(cand), hi = static_cast<uint32_t>(cand >> 32);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if ((lo >> t) & 1u) {
          lo &= ~dlo[t];
          hi &= ~dhi[t];
        }
      }
#pragma unroll
      for (int t = 32; t < kBlock; ++t) {
        if ((hi >> (t - 32)) & 1u) hi &= ~dhi[t];
      }
      const uint64_t kept = static_cast<uint64_t>(hi) << 32 | lo;
      alive[rb] = kept;
      block_keep = kept;
      if (rb + 1 < W) load_diagonal(mk, rb + 1, K, W, dlo, dhi);  // in flight during the OR pass
    }
    __syncthreads();
    const uint64_t kept = block_keep;
    const int later = W - rb - 1;
    if (kept != 0 && later > 0) {
      // the kept rows' words w > rb, ORed and cleared from alive[w]; with
      // few words left, `groups` threads share a word, each taking every
      // groups-th row
      const int groups = max(1, kScanThreads / later);
      for (int u = tid; u < later * groups; u += kScanThreads) {
        const int w = rb + 1 + u % later, g = u / later;
        const uint64_t* col = mk + static_cast<size_t>(rb) * kBlock * W + w;
        uint64_t acc = 0;
        for (int t0 = g; t0 < kBlock; t0 += kBatch * groups) {
          uint64_t v[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int t = t0 + k * groups;
            v[k] = t < kBlock && ((kept >> (t & 63)) & 1ull) ? col[static_cast<size_t>(t) * W] : 0ull;
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) acc |= v[k];
        }
        if (acc) atomicAnd(reinterpret_cast<unsigned long long*>(&alive[w]), ~acc);
      }
    }
    __syncthreads();
  }

  // the pack: kept rows before each word, a CTA-wide exclusive scan of the
  // words' popcounts, each thread over a run of words
  const int per = (W + kScanThreads - 1) / kScanThreads;
  const int w0 = min(tid * per, W), w1 = min(w0 + per, W);
  int count = 0;
  for (int w = w0; w < w1; ++w) count += __popcll(alive[w]);
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = incl - count, total = 0;
#pragma unroll
  for (int k = 0; k < kScanThreads / 32; ++k) {
    if (k < warp) before += warp_total[k];
    total += warp_total[k];
  }
  for (int w = w0; w < w1; ++w) {
    offset[w] = before;
    before += __popcll(alive[w]);
  }
  __syncthreads();

  int* kp = keep_out ? keep_out + static_cast<size_t>(blockIdx.x) * K : nullptr;
  float* o = out + static_cast<size_t>(blockIdx.x) * M * 6;
  for (int j = tid; j < K; j += kScanThreads) {
    const uint64_t word = alive[j >> 6];
    const int bit = j & 63;
    const int kept = static_cast<int>((word >> bit) & 1ull);
    if (kp) kp[j] = kept;
    if (kept) {
      const int slot = offset[j >> 6] + __popcll(word & ((1ull << bit) - 1ull));
      if (slot < M) {
        for (int c = 0; c < 6; ++c) o[slot * 6 + c] = d[static_cast<size_t>(j) * 6 + c];
      }
    }
  }
  for (int s = total + tid; s < M; s += kScanThreads) {
    for (int c = 0; c < 6; ++c) o[s * 6 + c] = -1.f;
  }
}

bool words_ok(int K, int W) { return K >= 1 && W == (K + kBlock - 1) / kBlock; }

}  // namespace

// The suppress words: dets (B, K, 6) f32, mask (B, K, W) u64, both contiguous
// on the current device; `W` and `tiles` are the plan's (nms_kernel.plan),
// checked here.  Returns the CUDA error of the launch (0 on success).
extern "C" int nms_mask_launch(const void* dets, void* mask, int B, int K, int W, int tiles,
                               float overlap_thresh, int force_suppress, void* stream) {
  if (B < 1 || B > kMaxBatch || !words_ok(K, W) ||
      static_cast<long long>(tiles) != static_cast<long long>(W) * (W + 1) / 2) {
    return cudaErrorInvalidValue;
  }
  nms_mask_kernel<<<dim3(tiles, B), kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dets), static_cast<uint64_t*>(mask), K, W, overlap_thresh, force_suppress);
  return cudaGetLastError();
}

// The greedy scan and the pack, after nms_mask_launch on the same stream:
// out (B, M, 6) f32, keep (B, K) i32 or null (not written); `smem` is the
// plan's (12 bytes a word), checked here.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int nms_scan_launch(const void* dets, const void* mask, void* out, void* keep, int B,
                               int K, int W, int M, int smem, float valid_thresh, void* stream) {
  if (B < 1 || !words_ok(K, W) || M < 1 || M > K || smem != 12 * W || smem > kMaxScanSmem) {
    return cudaErrorInvalidValue;
  }
  nms_scan_kernel<<<B, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dets), static_cast<const uint64_t*>(mask), static_cast<float*>(out),
      static_cast<int*>(keep), K, W, M, valid_thresh);
  return cudaGetLastError();
}
