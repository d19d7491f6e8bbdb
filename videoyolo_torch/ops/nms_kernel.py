"""ctypes wrapper of the greedy-NMS CUDA kernels (`csrc/nms.cu`).

The kernels port the TPU kernel `videoyolo_tpu/ops/pallas_nms.py:
nms_scan_pallas` (bit-equal keep mask) and also do the front-pack that
follows the greedy scan in the JAX package's `ops/nms.py:_nms_single`.  Their
plain PyTorch version is `ops/nms.py:nms_greedy_plain`.  A call is two
launches: the suppress words of the upper triangle of 64x64 tiles across the
card (`launch_mask`), then one CTA an image for the greedy scan, 64 rows at a
time, and the pack (`launch_scan`).  `plan` gives both launches' geometry and
the workspace; the C entry points check it.

The shared library is built by `ops/cuda_build.py` on first use and bound
with ctypes.  Importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build

SOURCE = cuda_build.PKG / "csrc" / "nms.cu"
# -fmad=false: no FMA contraction, so every IoU rounds as the plain version's
# separate multiply / add / divide do, and `iou > thresh` flips no bit
NVCC_FLAGS = ("-fmad=false",)

# keep in step with csrc/nms.cu
BLOCK = 64  # rows and columns of a mask tile: one 64-bit word
SCAN_SMEM_PER_WORD = 12  # the scan's shared memory: an alive word and its offset
MAX_BATCH = 65535  # the mask grid's y extent
# the most suppress-word bytes one call may take: 4 GiB holds K = 185,344 at
# B = 1 (the scan's shared memory then 34,752 bytes, under the 48 KB a CTA
# has without opting in) and K = 16,384 at B = 128
WORKSPACE_LIMIT = 1 << 32


class Plan(NamedTuple):
    words: int  # W = ceil(K / 64): suppress words a row
    tiles: int  # W (W + 1) / 2: mask CTAs an image, the upper triangle of 64x64 tiles
    mask_grid: Tuple[int, int]  # (tiles, B), 128 threads a CTA
    scan_grid: int  # one CTA an image, 128 threads
    scan_smem: int  # dynamic shared memory bytes of the scan CTA
    workspace: int  # bytes of the (B, K, W) uint64 suppress words


@functools.lru_cache(maxsize=64)
def plan(b: int, k: int) -> Plan:
    """Both launches' geometry for B images of K candidates.  Raises a
    ValueError for a K whose suppress words, B*K*W*8 bytes, exceed
    WORKSPACE_LIMIT, and for a B or K the grids cannot hold."""
    if not 1 <= b <= MAX_BATCH or k < 1:
        raise ValueError(f"nms_greedy takes 1 <= B <= {MAX_BATCH} and K >= 1, got B={b}, K={k}")
    w = -(-k // BLOCK)
    tiles = w * (w + 1) // 2
    pl = Plan(w, tiles, (tiles, b), b, SCAN_SMEM_PER_WORD * w, b * k * w * 8)
    if pl.workspace > WORKSPACE_LIMIT:
        raise ValueError(
            f"nms_greedy: B={b}, K={k} needs {pl.workspace} bytes of suppress words "
            f"(B*K*ceil(K/64)*8), more than the {WORKSPACE_LIMIT}-byte limit"
        )
    return pl


def build():
    """Compile `csrc/nms.cu` unless it was built already: (library path,
    ptxas report)."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    lib.nms_mask_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # dets, mask
        *[ctypes.c_int] * 4,  # B, K, W, tiles
        ctypes.c_float, ctypes.c_int,  # overlap_thresh, force_suppress
        ctypes.c_void_p,  # stream
    ]
    lib.nms_scan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dets, mask, out, keep
        *[ctypes.c_int] * 5,  # B, K, W, M, smem
        ctypes.c_float,  # valid_thresh
        ctypes.c_void_p,  # stream
    ]
    lib.nms_mask_launch.restype = lib.nms_scan_launch.restype = ctypes.c_int
    return lib


def launch_mask(dets: torch.Tensor, mask: torch.Tensor, pl: Plan, overlap_thresh: float,
                force_suppress: bool, stream: int):
    """The first launch: the suppress words of `dets` into `mask` (B, K, W)
    int64, on `stream` (a `cuda_stream` handle) of the current device.  Not
    counted: `nms_greedy` counts calls."""
    b, k, _ = dets.shape
    err = _library().nms_mask_launch(
        dets.data_ptr(), mask.data_ptr(), b, k, pl.words, pl.tiles, overlap_thresh,
        int(force_suppress), stream,
    )
    if err:
        raise RuntimeError(f"nms_greedy's mask launch failed with CUDA error {err} ({pl})")


def launch_scan(dets: torch.Tensor, mask: torch.Tensor, packed: torch.Tensor,
                keep: Optional[torch.Tensor], pl: Plan, valid_thresh: float, stream: int):
    """The second launch: the greedy scan over `mask` and the pack into
    `packed` (B, M, 6), and `keep` (B, K) int32 where given, on `stream` of
    the current device.  Not counted."""
    b, k, _ = dets.shape
    err = _library().nms_scan_launch(
        dets.data_ptr(), mask.data_ptr(), packed.data_ptr(),
        None if keep is None else keep.data_ptr(), b, k, pl.words, packed.shape[1],
        pl.scan_smem, valid_thresh, stream,
    )
    if err:
        raise RuntimeError(f"nms_greedy's scan launch failed with CUDA error {err} ({pl})")


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
    x2, y2) in descending score order; any K whose suppress words fit
    WORKSPACE_LIMIT (`plan`).  Returns `(packed (B, M, 6) float32, keep (B,
    K) int32)` with M = min(post_nms, K) (K when post_nms <= 0): the kept rows
    front-packed in score order and padded with -1 rows, and the greedy keep
    mask (None, and not written, when `return_keep` is false).  A call makes
    two CUDA launches on the current stream (`launch_mask`, `launch_scan`)
    and does not synchronise; `nms_greedy.launches` counts calls."""
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
    pl = plan(b, k)
    m = min(post_nms, k) if post_nms > 0 else k
    packed = torch.empty((b, m, 6), dtype=torch.float32, device=dets.device)
    keep = torch.empty((b, k), dtype=torch.int32, device=dets.device) if return_keep else None
    mask = torch.empty((b, k, pl.words), dtype=torch.int64, device=dets.device)
    with torch.cuda.device(dets.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch_mask(dets, mask, pl, overlap_thresh, force_suppress, stream)
        launch_scan(dets, mask, packed, keep, pl, valid_thresh, stream)
    nms_greedy.launches += 1
    return packed, keep


nms_greedy.launches = 0
