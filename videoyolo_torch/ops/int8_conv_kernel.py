"""ctypes wrappers of the int8 conv CUDA kernels (`csrc/int8_conv.cu`).

Two kernels, one template:

- `quant_downsample` is K3, the port of the TPU kernel
  `videoyolo_tpu/ops/pallas_conv.py:int8_s2d_downsample_conv`: the 3x3 /
  stride-2 conv of a fused-int8 cell with its reciprocal requant epilogue.
  Plain version: `ops/int8_conv.py:quant_downsample_plain`.
- `int8_conv` is the direct int8 cell, which the JAX package leaves to XLA's
  int8 `conv_general_dilated` (`models/layers.py:quant_conv_cell`).  Plain
  version: `ops/int8_conv.py:int8_conv_plain`.

Both equal their plain versions bit for bit.  Tensors are NCHW views of
`channels_last` memory, as the port's models keep them; a layout the kernels
do not take raises, it is never copied.  The shared library is built by
`ops/cuda_build.py` on first use and bound with ctypes.  Importing this module
needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = cuda_build.PKG / "csrc" / "int8_conv.cu"
# -fmad=false: no multiply-add contracted beyond the epilogue's explicit fmaf
NVCC_FLAGS = ("-fmad=false",)
# the epilogues (keep in step with csrc/int8_conv.cu)
EPI_RAW, EPI_F32, EPI_BF16, EPI_QUANT = 0, 1, 2, 3
_REAL_EPI = {torch.float32: EPI_F32, torch.bfloat16: EPI_BF16}


def build():
    """Compile `csrc/int8_conv.cu` unless it was built already: (library
    path, ptxas report)."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptrs = [ctypes.c_void_p] * 6  # x, w, scale, bias, oscale, out
    lib.int8_conv_launch.argtypes = ptrs + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.int8_conv_launch.restype = ctypes.c_int
    lib.int8_downsample_launch.argtypes = ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    does not synchronise; `int8_conv.launches` counts launches."""
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
    pad = k // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    if stride < 1 or ho < 1 or wo < 1:
        raise ValueError(f"int8_conv: no output for {tuple(q.shape)}, kernel {k}, stride {stride}")
    out = torch.empty((b, f, ho, wo), dtype=dtype, device=q.device, memory_format=torch.channels_last)
    with torch.cuda.device(q.device):
        err = _library().int8_conv_launch(
            q.data_ptr(), qkernel.data_ptr(), _ptr(scale), _ptr(bias), _ptr(oscale), out.data_ptr(),
            b, h, w, c, f, k, k, stride, epi, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"int8_conv launch failed with CUDA error {err}")
    int8_conv.launches += 1
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
    synchronise; `quant_downsample.launches` counts launches."""
    _check("quant_downsample", q, qkernel, [("scale", scale), ("bias", bias)], oscale)
    if qkernel.shape[-1] != 3:
        raise ValueError(f"quant_downsample takes a 3x3 kernel, got {tuple(qkernel.shape)}")
    b, c, h, w = q.shape
    f = qkernel.shape[0]
    out = torch.empty((b, f, (h + 1) // 2, (w + 1) // 2), dtype=torch.int8, device=q.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(q.device):
        err = _library().int8_downsample_launch(
            q.data_ptr(), qkernel.data_ptr(), scale.data_ptr(), bias.data_ptr(), oscale.data_ptr(),
            out.data_ptr(), b, h, w, c, f, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"quant_downsample launch failed with CUDA error {err}")
    quant_downsample.launches += 1
    return out


int8_conv.launches = 0
quant_downsample.launches = 0
