"""ctypes wrapper of the greedy-NMS CUDA kernel (`csrc/nms.cu`).

The kernel ports the TPU kernel `videoyolo_tpu/ops/pallas_nms.py:
nms_scan_pallas` (bit-equal keep mask) and also does the front-pack that
follows the greedy scan in the JAX package's `ops/nms.py:_nms_single`.  Its
plain PyTorch version is `ops/nms.py:nms_greedy_plain`.

The shared library is built by `ops/cuda_build.py` on first use and bound
with ctypes.  Importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = cuda_build.PKG / "csrc" / "nms.cu"
# -fmad=false: no FMA contraction, so every IoU rounds as the plain version's
# separate multiply / add / divide do, and `iou > thresh` flips no bit
NVCC_FLAGS = ("-fmad=false",)
MAX_K = 1024  # one warp holds the keep mask: 32 words of 32 bits


def build():
    """Compile `csrc/nms.cu` unless it was built already: (library path,
    ptxas report)."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.nms_greedy_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dets, out, keep
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, K, M
        ctypes.c_float, ctypes.c_float, ctypes.c_int,  # thresholds, force
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


def nms_greedy(
    dets: torch.Tensor,
    overlap_thresh: float = 0.45,
    valid_thresh: float = 0.01,
    post_nms: int = 100,
    force_suppress: bool = False,
    return_keep: bool = True,
):
    """Greedy NMS on score-sorted candidates, on the card.

    dets: (B, K, 6) float32 CUDA tensor, contiguous, rows (id, score, x1, y1,
    x2, y2) in descending score order, 1 <= K <= 1024.  Returns
    `(packed (B, M, 6) float32, keep (B, K) int32)` with M = min(post_nms, K)
    (K when post_nms <= 0): the kept rows front-packed in score order and
    padded with -1 rows, and the greedy keep mask (None, and not written,
    when `return_keep` is false).  Launches on the current stream and does
    not synchronise; `nms_greedy.launches` counts launches."""
    if dets.device.type != "cuda":
        raise ValueError(
            f"nms_greedy runs on CUDA tensors only (got {dets.device}); "
            "ops/nms.py:nms_greedy_plain is its CPU version"
        )
    if dets.dtype != torch.float32 or dets.dim() != 3 or dets.shape[-1] != 6:
        raise ValueError(f"nms_greedy takes (B, K, 6) float32, got {tuple(dets.shape)} {dets.dtype}")
    if not dets.is_contiguous():
        raise ValueError("nms_greedy takes a contiguous tensor")
    b, k, _ = dets.shape
    if b < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"nms_greedy takes B >= 1 and 1 <= K <= {MAX_K}, got B={b}, K={k}")
    m = min(post_nms, k) if post_nms > 0 else k
    packed = torch.empty((b, m, 6), dtype=torch.float32, device=dets.device)
    keep = torch.empty((b, k), dtype=torch.int32, device=dets.device) if return_keep else None
    fn = _library().nms_greedy_launch
    with torch.cuda.device(dets.device):
        err = fn(
            dets.data_ptr(), packed.data_ptr(), None if keep is None else keep.data_ptr(), b, k, m,
            overlap_thresh, valid_thresh, int(force_suppress),
            torch.cuda.current_stream(dets.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"nms_greedy launch failed with CUDA error {err}")
    nms_greedy.launches += 1
    return packed, keep


nms_greedy.launches = 0
