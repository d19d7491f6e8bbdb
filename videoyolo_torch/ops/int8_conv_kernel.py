"""ctypes wrappers of the int8 conv CUDA kernels (`csrc/int8_conv.cu`).

Two kernels, one template:

- `quant_downsample` is K3, the port of the TPU kernel
  `videoyolo_tpu/ops/pallas_conv.py:int8_s2d_downsample_conv`: the 3x3 /
  stride-2 conv of a fused-int8 cell with its reciprocal requant epilogue.
  Plain version: `ops/int8_conv.py:quant_downsample_plain`.
- `int8_conv` is the direct int8 cell, which the JAX package leaves to XLA's
  int8 `conv_general_dilated` (`models/layers.py:quant_conv_cell`).  Plain
  version: `ops/int8_conv.py:int8_conv_plain`.

Both equal their plain versions bit for bit.  `plan` chooses each launch's
route and tile from the shape and the alignment; the C entry points check
them.  Tensors are NCHW views of `channels_last` memory, as the port's models
keep them; a layout the kernels do not take raises, it is never copied.  The
shared library is built by `ops/cuda_build.py` on first use and bound with
ctypes.  Importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import cuda_build

SOURCE = cuda_build.PKG / "csrc" / "int8_conv.cu"
# -fmad=false: no multiply-add contracted beyond the epilogue's explicit fmaf
NVCC_FLAGS = ("-fmad=false",)
# the epilogues (keep in step with csrc/int8_conv.cu)
EPI_RAW, EPI_F32, EPI_BF16, EPI_QUANT = 0, 1, 2, 3
_REAL_EPI = {torch.float32: EPI_F32, torch.bfloat16: EPI_BF16}

# the routes by the alignment of C and the pointers, and their tiling (keep
# in step with csrc/int8_conv.cu)
ROUTES = {16: "wgmma", 4: "mma_word", 1: "mma_byte"}
ROUTE_IDS = {"mma_byte": 0, "mma_word": 1, "wgmma": 2}
BM = 128  # output pixels per CTA
MMA_ROW = 64 + 16  # the mma.sync routes' stage row: 64 bytes of K, padded
# K at and above which the wgmma route takes 128-byte stages in a 3-deep
# ring (half the barriers per product) rather than 64-byte ones 4 deep: on
# an H100 they were 9-14% faster at K = 1152-4608, even at 576, slower below
DEEP_K = 1152
MAX_GRID = 2**31 - 1


class Plan(NamedTuple):
    route: str
    bm: int
    bn: int
    bk: int  # bytes of K per stage
    stages: int
    smem: int  # dynamic shared memory bytes
    grid: int  # CTAs


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def out_size(h: int, k: int, stride: int) -> int:
    return (h + 2 * (k // 2) - k) // stride + 1


def alignment(c: int, *ptrs: int) -> int:
    """The largest of 16, 4 and 1 that divides C and every pointer."""
    return next(n for n in (16, 4, 1) if c % n == 0 and all(p % n == 0 for p in ptrs))


def plan(b: int, h: int, w: int, c: int, f: int, k: int, stride: int, align: int) -> Plan:
    """The route and tile of one launch on a (B, H, W, C) input, F output
    channels, a k x k kernel at `stride`, with C and both pointers aligned to
    `align` (16, 4 or 1).

    The route follows the alignment: 16-byte copies multiplied by wgmma,
    4-byte copies or single bytes multiplied by mma.sync.  A CTA takes BM =
    128 output pixels and BN channels: 32 for F <= 32 (no half-idle tile),
    64 for F <= 64, else 128 on the wgmma route and 64 on the others.  K
    advances BK = 64 bytes a stage, through a ring of 3 stages (mma.sync,
    rows padded to 80 bytes) or 4 (wgmma); a wgmma tile of BN = 128 with
    K = k*k*C >= DEEP_K takes 128-byte stages, 3 deep.  Shared memory holds
    the ring or the staged output tile of the widest epilogue (int32 rows of
    BN values, each with room for its 16-byte offset), whichever is
    larger."""
    route = ROUTES[align]
    wide = route == "wgmma"
    bn = 32 if f <= 32 else 64 if f <= 64 or not wide else 128
    bk = 128 if wide and bn == 128 and k * k * c >= DEEP_K else 64
    stages = 4 if wide and bk == 64 else 3
    ring = stages * (BM + bn) * (bk if wide else MMA_ROW)
    smem = max(ring, BM * (bn * 4 + 16))
    m = b * out_size(h, k, stride) * out_size(w, k, stride)
    return Plan(route, BM, bn, bk, stages, smem, _ceil_div(m, BM) * _ceil_div(f, bn))


def build():
    """Compile `csrc/int8_conv.cu` unless it was built already: (library
    path, ptxas report)."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptrs = [ctypes.c_void_p] * 6  # x, w, scale, bias, oscale, out
    tile = [ctypes.c_int] * 7  # route, bm, bn, bk, stages, smem, grid
    lib.int8_conv_launch.argtypes = ptrs + [ctypes.c_int] * 9 + tile + [ctypes.c_void_p]
    lib.int8_conv_launch.restype = ctypes.c_int
    lib.int8_downsample_launch.argtypes = ptrs + [ctypes.c_int] * 5 + tile + [ctypes.c_void_p]
    lib.int8_downsample_launch.restype = ctypes.c_int
    return lib


def _check(name: str, q: torch.Tensor, qkernel: torch.Tensor, vectors, oscale):
    """The layouts the kernels take; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(
            f"{name} runs on CUDA tensors only (got {q.device}); "
            "ops/int8_conv.py holds its CPU version"
        )
    if q.dtype != torch.int8 or q.dim() != 4 or not q.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} takes an int8 NCHW input in channels_last memory, got "
                         f"{tuple(q.shape)} {q.dtype} strides {q.stride()}")
    f, c, kh, kw = qkernel.shape
    if (qkernel.dtype != torch.int8 or qkernel.device != q.device or c != q.shape[1] or kh != kw
            or kh % 2 == 0 or not qkernel.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{name} takes an int8 (F, {q.shape[1]}, k, k) kernel, k odd, in "
                         f"channels_last memory on {q.device}, got {tuple(qkernel.shape)} "
                         f"{qkernel.dtype} strides {qkernel.stride()} on {qkernel.device}")
    for vname, v in vectors:
        if v.dtype != torch.float32 or v.shape != (f,) or not v.is_contiguous() or v.device != q.device:
            raise ValueError(f"{name} takes {vname} as ({f},) float32 on {q.device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")
    if oscale is not None and (oscale.dtype != torch.float32 or oscale.numel() != 1
                               or oscale.device != q.device):
        raise ValueError(f"{name} takes oscale as a float32 scalar on {q.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _plan_for(name: str, q: torch.Tensor, qkernel: torch.Tensor, stride: int) -> Plan:
    b, c, h, w = q.shape
    f, _, k, _ = qkernel.shape
    pl = plan(b, h, w, c, f, k, stride, alignment(c, q.data_ptr(), qkernel.data_ptr()))
    if pl.grid > MAX_GRID:
        raise ValueError(f"{name}: {pl.grid} CTAs for {tuple(q.shape)}, more than a grid holds")
    return pl


def _tile_args(pl: Plan):
    return ROUTE_IDS[pl.route], pl.bm, pl.bn, pl.bk, pl.stages, pl.smem, pl.grid


def int8_conv(
    q: torch.Tensor,
    qkernel: torch.Tensor,
    stride: int = 1,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    oscale: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The direct int8 conv cell on the card (pad k // 2, int32 sums).

    q (B, C, H, W) int8, qkernel (F, C, k, k) int8, both in channels_last
    memory.  Without `scale`: the raw int32 sums.  With `scale` and `bias`
    ((F,) float32): y = leaky(acc * scale + bias) rounded once, then int8
    round(y / oscale) clipped to +-127 when `oscale` (a float32 scalar on the
    card) is given, else y in `out_dtype` (float32 or bf16).  Returns (B, F,
    Ho, Wo) in channels_last memory.  Launches on the current stream and
    does not synchronise; `int8_conv.launches` counts launches and
    `int8_conv.route_launches` them by route."""
    if scale is None:
        epi, dtype = EPI_RAW, torch.int32
    elif oscale is not None:
        epi, dtype = EPI_QUANT, torch.int8
    elif out_dtype in _REAL_EPI:
        epi, dtype = _REAL_EPI[out_dtype], out_dtype
    else:
        raise ValueError(f"int8_conv writes float32 or bf16, got {out_dtype}")
    if (scale is None) != (bias is None) or (scale is None and oscale is not None):
        raise ValueError("int8_conv takes scale and bias together, and oscale only with them")
    _check("int8_conv", q, qkernel, [] if scale is None else [("scale", scale), ("bias", bias)], oscale)
    b, c, h, w = q.shape
    f, _, k, _ = qkernel.shape
    ho, wo = out_size(h, k, stride), out_size(w, k, stride)
    if stride < 1 or ho < 1 or wo < 1:
        raise ValueError(f"int8_conv: no output for {tuple(q.shape)}, kernel {k}, stride {stride}")
    pl = _plan_for("int8_conv", q, qkernel, stride)
    out = torch.empty((b, f, ho, wo), dtype=dtype, device=q.device, memory_format=torch.channels_last)
    with torch.cuda.device(q.device):
        err = _library().int8_conv_launch(
            q.data_ptr(), qkernel.data_ptr(), _ptr(scale), _ptr(bias), _ptr(oscale), out.data_ptr(),
            b, h, w, c, f, k, k, stride, epi, *_tile_args(pl),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"int8_conv launch failed with CUDA error {err} ({pl})")
    int8_conv.launches += 1
    int8_conv.route_launches[pl.route] += 1
    return out


def quant_downsample(
    q: torch.Tensor, qkernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    oscale: torch.Tensor,
) -> torch.Tensor:
    """K3 on the card: the fused-int8 3x3 / stride-2 / pad-1 downsample.

    q (B, C, H, W) int8, qkernel (F, C, 3, 3) int8, both in channels_last
    memory; scale, bias (F,) float32 (scale = input scale x wscale); oscale
    a float32 scalar on the card.  Returns int8 round(leaky(acc * scale +
    bias) * (1 / oscale)) clipped to +-127, (B, F, ceil(H/2), ceil(W/2)) in
    channels_last memory.  Launches on the current stream and does not
    synchronise; `quant_downsample.launches` counts launches and
    `quant_downsample.route_launches` them by route."""
    _check("quant_downsample", q, qkernel, [("scale", scale), ("bias", bias)], oscale)
    if qkernel.shape[-1] != 3:
        raise ValueError(f"quant_downsample takes a 3x3 kernel, got {tuple(qkernel.shape)}")
    b, c, h, w = q.shape
    f = qkernel.shape[0]
    pl = _plan_for("quant_downsample", q, qkernel, 2)
    out = torch.empty((b, f, (h + 1) // 2, (w + 1) // 2), dtype=torch.int8, device=q.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(q.device):
        err = _library().int8_downsample_launch(
            q.data_ptr(), qkernel.data_ptr(), scale.data_ptr(), bias.data_ptr(), oscale.data_ptr(),
            out.data_ptr(), b, h, w, c, f, *_tile_args(pl), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"quant_downsample launch failed with CUDA error {err} ({pl})")
    quant_downsample.launches += 1
    quant_downsample.route_launches[pl.route] += 1
    return out


int8_conv.launches = quant_downsample.launches = 0
int8_conv.route_launches = dict.fromkeys(ROUTE_IDS, 0)
quant_downsample.route_launches = dict.fromkeys(ROUTE_IDS, 0)
