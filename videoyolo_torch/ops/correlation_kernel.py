"""ctypes wrapper of the cost-volume CUDA kernel (`csrc/correlation.cu`).

The kernel ports the TPU kernel `videoyolo_tpu/ops/pallas_correlation.py:
correlation_pallas`: the correlation of kernel_size=1, stride1=1, multiply.
Its plain PyTorch version is `ops/correlation.py:correlation_plain`, to which
it agrees within float32 summation order (the same products, summed over C in
another order).  `plan` chooses each launch's tile, register tile and
displacement group from the shape; the C entry point checks it.

The shared library is built by `ops/cuda_build.py` on first use and bound
with ctypes.  Importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import cuda_build

SOURCE = cuda_build.PKG / "csrc" / "correlation.cu"
# no -fmad=false: the kernel is held to its plain version with a tolerance
NVCC_FLAGS = ()

# the kernel's tiling and instances (keep in step with csrc/correlation.cu)
ROWS = 8  # output rows per tile: one per lane of a quarter-warp
CHUNK = 16  # channels staged at a time: 64 bytes a pixel
ROW_PAD = 4  # floats (16 bytes) after each staged row
GROUP_X = (1, 3, 5, 7, 9)  # displacement columns per CTA
SMEM_BYTES = 112 * 1024
SMS = 132  # an H100's SMs
MIN_CTAS = 2 * SMS
# the instances' (R pixels a thread, gy displacement rows, warps a CTA,
# least CTAs), in order of preference: R=2 in one warp where the launch
# fills the card four CTAs deep, else R=1 in two warps, both on 8x8-pixel
# tiles; one displacement row a CTA where three are not allowed or give too
# few CTAs; one warp of R=1 last
CANDIDATES = ((2, 3, 1, 4 * SMS), (1, 3, 2, MIN_CTAS), (2, 1, 1, 4 * SMS), (1, 1, 2, MIN_CTAS),
              (1, 1, 1, MIN_CTAS))
MAX_BATCH = 65535  # the grid's z extent
MAX_GROUPS = 65535  # the grid's y extent


class Plan(NamedTuple):
    r: int  # output pixels a thread takes, side by side in a row: the register tile
    gx: int  # displacement columns per CTA
    gy: int  # displacement rows per CTA
    nacc: int  # accumulators per thread: r * gx * gy
    tile: Tuple[int, int]  # output (rows, columns) per CTA
    threads: int
    copy: int  # bytes per staging copy: 16, or 4 where C or the inputs are not 16-byte aligned
    smem: int  # dynamic shared memory bytes
    grid: Tuple[int, int, int]  # (pixel tiles, displacement groups, images)
    live: float  # share of the tiles' pixel slots that lie inside the image

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _balanced(steps: int, most: int) -> int:
    """The group size that splits `steps` into the fewest, most even groups
    of at most `most`."""
    return _ceil_div(steps, _ceil_div(steps, most))


def _row_floats(n: int) -> int:
    """Floats in one staged row of n pixels: an odd number of 16-byte units."""
    return n * CHUNK + ROW_PAD


def _make(b, h, w, c, steps, stride2, r, gx, gy, warps, aligned) -> Plan:
    tw = 4 * r * warps
    halo_w, halo_h = tw + (gx - 1) * stride2, ROWS + (gy - 1) * stride2
    staged = (ROWS * _row_floats(tw) + halo_h * _row_floats(halo_w)) * 4
    results = ROWS * tw * (gx * gy | 1) * 4
    tiles_y, tiles_x = _ceil_div(h, ROWS), _ceil_div(w, tw)
    return Plan(
        r, gx, gy, r * gx * gy, (ROWS, tw), 32 * warps, 16 if aligned and c % 4 == 0 else 4,
        max(staged, results), (tiles_y * tiles_x, _ceil_div(steps, gx) * _ceil_div(steps, gy), b),
        h * w / (tiles_y * ROWS * tiles_x * tw),
    )


def plan(b: int, h: int, w: int, c: int, max_displacement: int, stride2: int, aligned: bool = True) -> Plan:
    """How the kernel cuts one launch on (B, H, W, C) inputs; `aligned` when
    both inputs' pointers and batch strides are 16-byte aligned.

    A CTA takes 8 rows x 4*R*warps columns of output pixels, a thread R
    neighbouring pixels of a row (R = 2 only where stride2 == 1: the two
    share f2 pixels across displacement columns), and a group of gy rows x gx
    columns of the displacement grid: gx the fewest, most even groups of at
    most 9 columns (rounded up to an instance), gy 3 or 1, gy > 1 only where
    gx covers a whole row, so a group's displacements are one run of output
    channels.  The first of CANDIDATES whose staged chunk fits SMEM_BYTES,
    that gives its least CTAs and keeps at least half of its pixel slots
    inside the image is taken; where none does (a small launch), the fitting
    one with the most CTAs, those with half their slots live first, then the
    most live.  gx narrows only where no group fits the shared memory.

    The candidates follow the times of every (R, gy, warps), R in 1, 2 and
    4, at the main path's levels (B=32, d=4) on an H100 80GB HBM3 at 700 W
    (probe_cost_volume.py): R=2, gy=3 in one warp was the fastest at
    52x52x256 (0.366 ms; R=1 0.440, R=4 in two warps 0.510) and 26x26x512
    (0.224; R=4 0.310); at 13x13x1024, with 384 such CTAs, R=1, gy=3 in two
    warps was (0.254; R=2 in one warp 0.291, R=4 with gy=1 0.370).  R=4
    lost everywhere: at 184 registers a thread, an SM holds too few warps to
    hide the staging's latency.  So the main path takes R=2, gy=3, one warp
    at 52x52 and 26x26 (4,704 and 1,536 CTAs) and R=1, gy=3, two warps at
    13x13 (384 CTAs)."""
    steps = 2 * (max_displacement // stride2) + 1
    widest = next(g for g in GROUP_X if g >= _balanced(steps, GROUP_X[-1]))
    for gx in reversed([g for g in GROUP_X if g <= widest]):
        fits = [
            (pl, least) for r, gy, warps, least in CANDIDATES if (r == 1 or stride2 == 1) and (gy == 1 or gx == steps >= gy)
            for pl in [_make(b, h, w, c, steps, stride2, r, gx, gy, warps, aligned)] if pl.smem <= SMEM_BYTES
        ]
        if fits:
            return next((pl for pl, least in fits if pl.ctas >= least and pl.live >= 0.5),
                        max((pl for pl, _ in fits), key=lambda pl: (pl.live >= 0.5, pl.ctas, pl.live)))
    raise AssertionError("unreachable: one warp of one displacement always fits")


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
        *[ctypes.c_int] * 8,  # the plan: r, gx, gy, threads, copy, smem, tiles, groups
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


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


def aligned(*ts: torch.Tensor) -> bool:
    """Whether each tensor's pointer and batch stride allow 16-byte copies."""
    return all(t.data_ptr() % 16 == 0 and (t.shape[0] == 1 or t.stride(0) % 4 == 0) for t in ts)


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
    pl = plan(b, h, w, c, max_displacement, stride2, aligned(f1, f2))
    if pl.grid[1] > MAX_GROUPS:
        raise ValueError(f"cost_volume: {pl.grid[1]} displacement groups for d={max_displacement}, "
                         f"stride2={stride2}, more than a grid holds")
    steps = 2 * (max_displacement // stride2) + 1
    out = torch.empty((b, h, w, steps * steps), dtype=torch.float32, device=f1.device)
    fn = _library().cost_volume_launch
    with torch.cuda.device(f1.device):
        err = fn(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), f1.stride(0), f2.stride(0),
            b, h, w, c, max_displacement, stride2,
            pl.r, pl.gx, pl.gy, pl.threads, pl.copy, pl.smem, pl.grid[0], pl.grid[1],
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"cost_volume launch failed with CUDA error {err} ({pl})")
    cost_volume.launches += 1
    return out


cost_volume.launches = 0
