"""ctypes wrapper of the cost-volume CUDA kernel (`csrc/correlation.cu`).

The kernel ports the TPU kernel `videoyolo_tpu/ops/pallas_correlation.py:
correlation_pallas`: the correlation of kernel_size=1, stride1=1, multiply.
Its plain PyTorch version is `ops/correlation.py:correlation_plain`, to which
it agrees within float32 summation order (the same products, summed over C in
another order).

The shared library is built by `ops/cuda_build.py` on first use and bound
with ctypes.  Importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import cuda_build

SOURCE = cuda_build.PKG / "csrc" / "correlation.cu"
# no -fmad=false: the kernel is held to its plain version with a tolerance
NVCC_FLAGS = ()

# the kernel's tiling (keep in step with csrc/correlation.cu)
TILE_W, TILE_H = 32, 8
THREADS = TILE_W * TILE_H
CHUNK = 32  # channels staged at a time: one per lane
SMEM_BYTES = 112 * 1024  # two CTAs per SM
ACCUMULATORS = (1, 4, 9, 16, 21, 25, 27, 32)  # the kernel's NACC instantiations
MAX_BATCH = 65535  # the grid's z extent


def build():
    """Compile `csrc/correlation.cu` unless it was built already: (library
    path, ptxas report)."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.cost_volume_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # f1, f2, out
        ctypes.c_longlong, ctypes.c_longlong,  # batch strides of f1, f2
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, C
        ctypes.c_int, ctypes.c_int,  # max_displacement, stride2
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # gx, gy, nacc
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _balanced(steps: int, most: int) -> int:
    """The group size that splits `steps` into the fewest, most even groups
    of at most `most`."""
    return _ceil_div(steps, _ceil_div(steps, most))


def staged_bytes(gx: int, gy: int, stride2: int) -> int:
    """Shared memory of one staged chunk: CHUNK channels of the f1 tile and
    of the f2 halo a gy x gx displacement group reaches (odd plane strides)."""
    halo = (TILE_H + (gy - 1) * stride2) * (TILE_W + (gx - 1) * stride2) | 1
    return CHUNK * (THREADS + 1 + halo) * 4


def plan(max_displacement: int, stride2: int) -> Tuple[int, int, int]:
    """How the kernel cuts the displacements: (gx, gy, nacc).

    Each CTA takes gy rows x gx columns of the displacement grid (at most 32
    displacements; gx == steps or gy == 1, so a group's displacements are
    one run of output channels) and keeps `nacc >= gx*gy` accumulators per
    thread.  Groups shrink (rows first) until a staged chunk fits
    SMEM_BYTES."""
    steps = 2 * (max_displacement // stride2) + 1
    most = ACCUMULATORS[-1]
    gx = _balanced(steps, most)
    gy = _balanced(steps, max(1, most // gx))
    while staged_bytes(gx, gy, stride2) > SMEM_BYTES and gx * gy > 1:
        if gy > 1:
            gy -= 1
        else:
            gx -= 1
    nacc = next(n for n in ACCUMULATORS if n >= gx * gy)
    return gx, gy, nacc


def _check(name: str, t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(
            f"cost_volume runs on CUDA tensors only (got {name} on {t.device}); "
            "ops/correlation.py:correlation_plain is its CPU version"
        )
    if t.dtype != torch.float32 or t.dim() != 4:
        raise ValueError(f"cost_volume takes (B, H, W, C) float32, got {name} {tuple(t.shape)} {t.dtype}")
    _, h, w, c = t.shape
    # dense over (H, W, C); any batch stride (a frame slice of a window)
    for size, stride, want in zip((h, w, c), t.stride()[1:], (w * c, c, 1)):
        if size > 1 and stride != want:
            raise ValueError(f"cost_volume takes {name} dense over (H, W, C), got strides {t.stride()}")


def cost_volume(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int, stride2: int = 1
) -> torch.Tensor:
    """Cost volume on the card (kernel_size=1, stride1=1, multiply).

    f1, f2: (B, H, W, C) float32 CUDA tensors, each dense over (H, W, C)
    with any batch stride, so the frames of a (B, T, H, W, C) window are
    taken as slices, without a copy.  Returns (B, H, W, D) float32,
    contiguous, D = (2*(max_displacement//stride2)+1)^2:
    `out[..., iy*steps+ix] = sum_c f1 * f2 shifted by ((iy-s)*stride2,
    (ix-s)*stride2) / C`, f2 zero outside the image.  Launches on the current
    stream and does not synchronise; `cost_volume.launches` counts
    launches."""
    _check("f1", f1)
    _check("f2", f2)
    if f1.shape != f2.shape or f1.device != f2.device:
        raise ValueError(f"cost_volume takes f1, f2 of one shape and device, got "
                         f"{tuple(f1.shape)} on {f1.device}, {tuple(f2.shape)} on {f2.device}")
    b, h, w, c = f1.shape
    if min(b, h, w, c) < 1 or b > MAX_BATCH:
        raise ValueError(f"cost_volume takes 1 <= B <= {MAX_BATCH} and H, W, C >= 1, got {tuple(f1.shape)}")
    if max_displacement < 0 or stride2 < 1:
        raise ValueError(f"cost_volume takes d >= 0 and stride2 >= 1, got {max_displacement}, {stride2}")
    steps = 2 * (max_displacement // stride2) + 1
    gx, gy, nacc = plan(max_displacement, stride2)
    out = torch.empty((b, h, w, steps * steps), dtype=torch.float32, device=f1.device)
    fn = _library().cost_volume_launch
    with torch.cuda.device(f1.device):
        err = fn(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), f1.stride(0), f2.stride(0),
            b, h, w, c, max_displacement, stride2, gx, gy, nacc,
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"cost_volume launch failed with CUDA error {err}")
    cost_volume.launches += 1
    return out


cost_volume.launches = 0
