"""ctypes wrappers of the cost-volume CUDA kernels (`csrc/correlation.cu`).

`cost_volume` ports the TPU kernel `videoyolo_tpu/ops/pallas_correlation.py:
correlation_pallas`: the correlation of kernel_size=1, stride1=1, multiply.
Its plain PyTorch version is `ops/correlation.py:correlation_plain`, to which
it agrees within float32 summation order (the same products, summed over C in
another order).  `plan` chooses each launch's tile, register tile and
displacement group from the shape; the C entry point checks it.

`cost_volume_backward` is its adjoint, the gradients of f1 and f2 given the
output's, in one launch cut as `plan_backward` says;
`cost_volume_pair_backward` the adjoint of the two volumes the Corr layer
takes of a window of 3 frames (frames 0 and 2 against frame 1), in one
launch.  The TPU kernel has none: the JAX package
differentiates the XLA form (`videoyolo_tpu/ops/correlation.py:64-80`).  Its
plain version, `cost_volume_backward_plain`, writes the adjoint out in torch
ops, one shifted product per displacement.

The shared library is built by `ops/cuda_build.py` on first use and bound
with ctypes.  Importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
from torch.nn import functional as F

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
# the adjoint's tiling: a thread takes 8 channels (two float4s) of R
# neighbouring pixels; (R, column groups a CTA) in order of preference, each
# an 8x8-pixel tile of 16 x column groups threads: R=2 in two warps, or R=1
# in four where stride2 > 1
BACKWARD_CANDIDATES = ((2, 4), (1, 8))
BACKWARD_R = (1, 2)  # the kernel's instances of R
BACKWARD_MIN_CTAS = 3 * SMS  # C is cut into slabs until a launch has this many CTAs


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


def _steps(max_displacement: int, stride2: int) -> int:
    """Displacements along each axis of the grid."""
    return 2 * (max_displacement // stride2) + 1


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
    steps = _steps(max_displacement, stride2)
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


class BackwardPlan(NamedTuple):
    r: int  # output pixels a thread takes, side by side in a row, 8 channels each
    gx: int  # displacement columns per group
    gy: int  # displacement rows per group
    tile: Tuple[int, int]  # output (rows, columns) per CTA
    slab: int  # channels per CTA, a multiple of CHUNK (the last slab may be short)
    threads: int
    copy: int  # bytes per staging copy: 16, or 4 where C or the inputs are not 16-byte aligned
    smem: int  # dynamic shared memory bytes: the partner's window and the tile's g
    grid: Tuple[int, int, int]  # (pixel tiles, 2 roles (the pair: 4) x slabs, images)
    live: float  # share of the tiles' pixel slots that lie inside the image

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _g_floats(n: int) -> int:
    """Floats a staged pixel of g takes for n displacements: at least n, and
    4 past a multiple of 8, so that the 16 pixels a warp reads lie in
    distinct banks at the main path's 81."""
    return (n + 3) // 8 * 8 + 4


def _make_backward(b, h, w, c, stride2, r, column_groups, gx, gy, slab, aligned, roles=2) -> BackwardPlan:
    tw = r * column_groups
    win_w, win_h = tw + (gx - 1) * stride2, ROWS + (gy - 1) * stride2
    smem = (win_h * _row_floats(win_w) + ROWS * (tw * _g_floats(gx * gy) + 1)) * 4
    tiles_y, tiles_x = _ceil_div(h, ROWS), _ceil_div(w, tw)
    return BackwardPlan(
        r, gx, gy, (ROWS, tw), slab, 16 * column_groups, 16 if aligned and c % 4 == 0 else 4, smem,
        (tiles_y * tiles_x, roles * _ceil_div(c, slab), b), h * w / (tiles_y * ROWS * tiles_x * tw),
    )


def plan_backward(b: int, h: int, w: int, c: int, max_displacement: int, stride2: int,
                  aligned: bool = True, pair: bool = False) -> BackwardPlan:
    """How the adjoint kernel cuts one launch on (B, H, W, C) inputs;
    `aligned` when the inputs' pointers and batch strides are 16-byte
    aligned; `pair` for the launch of two volumes that share their second
    frame (three gradients: four roles a slab, the shared frame's in two
    halves of it).  Raises ValueError on what the kernel cannot take.

    A CTA takes one image, one gradient, 8 rows x 8 columns of output pixels
    and a slab of channels; a thread R neighbouring pixels of a row (R = 2
    only where stride2 == 1) and 8 channels of each.  R is the first of
    BACKWARD_CANDIDATES the stride allows.  The displacements are walked in
    groups of gy rows x gx columns: gx as the forward's, gy the most rows
    whose window and g fit SMEM_BYTES where gx covers a whole row, else 1.
    The slab is C cut into the fewest even slabs (multiples of CHUNK) that
    give the launch BACKWARD_MIN_CTAS CTAs, or CHUNK where none do.

    The candidates and the CTA count follow the times of every (R, slab) at
    the train step's levels (B=16, d=4) on an H100 80GB HBM3 at 700 W
    (probe_cost_volume.py --sweep): R=2 in two warps was the fastest at
    every level (0.355-0.364 / 0.236 / 0.124 ms at 52x52x256 / 26x26x512 /
    13x13x1024 at its best slabs), R=1 in four warps next (0.407 / 0.278 /
    0.145), R=4 in one warp last (0.490 / 0.309 / 0.167): at 38 KB of shared
    memory an SM holds 5 CTAs, so warps come from threads a CTA.  About 512
    CTAs was enough: 13x13x1024 took 0.124 ms at 512 (slab 256), 0.141 at
    1,024 and 0.342 at 128 (no cut); 26x26x512 0.236 at 512, 0.256 at 1,024;
    at 52x52x256 1,568 CTAs (no cut) and 3,136 were within 3%.  The pair
    at the rule's slabs was within 5% of the best slab swept at each level."""
    if min(b, h, w, c) < 1 or b > MAX_BATCH or max_displacement < 0 or stride2 < 1:
        raise ValueError(f"cost_volume_backward takes 1 <= B <= {MAX_BATCH}, H, W, C >= 1, d >= 0 and "
                         f"stride2 >= 1, got B, H, W, C = {b}, {h}, {w}, {c}, d={max_displacement}, "
                         f"stride2={stride2}")
    steps = _steps(max_displacement, stride2)
    roles = 4 if pair else 2  # the pair: gf_a, gf_b and two halves of gf_m's slab
    r, groups = next(cand for cand in BACKWARD_CANDIDATES if cand[0] == 1 or stride2 == 1)
    widest = next(g for g in GROUP_X if g >= _balanced(steps, GROUP_X[-1]))
    pl = next(pl for gx in reversed([g for g in GROUP_X if g <= widest])
              for gy in (range(steps, 0, -1) if gx == steps else (1,))
              for pl in [_make_backward(b, h, w, c, stride2, r, groups, gx, gy, CHUNK, aligned, roles)]
              if pl.smem <= SMEM_BYTES)
    n = 1
    while True:
        slab = _ceil_div(_ceil_div(c, n), CHUNK) * CHUNK
        pl = pl._replace(slab=slab, grid=(pl.grid[0], roles * _ceil_div(c, slab), b))
        if pl.ctas >= BACKWARD_MIN_CTAS or slab == CHUNK:
            break
        n += 1
    return pl


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
    bwd = lib.cost_volume_backward_launch
    bwd.argtypes = [
        *[ctypes.c_void_p] * 8,  # g, g2, f1, f2, f3, gf1, gf2, gf3
        *[ctypes.c_longlong] * 3,  # batch strides of f1, f2, f3
        *[ctypes.c_int] * 7,  # B, H, W, C, max_displacement, stride2, pair
        *[ctypes.c_int] * 9,  # the plan: r, gx, gy, slab, threads, copy, smem, tiles, slabs
        ctypes.c_void_p,  # stream
    ]
    bwd.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, fn: str = "cost_volume", plain: str = "ops/correlation.py:correlation_plain"):
    if t.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors only (got {name} on {t.device}); {plain} is its CPU version")
    if t.dtype != torch.float32 or t.dim() != 4:
        raise ValueError(f"{fn} takes (B, H, W, C) float32, got {name} {tuple(t.shape)} {t.dtype}")
    _, h, w, c = t.shape
    # dense over (H, W, C); any batch stride (a frame slice of a window)
    for size, stride, want in zip((h, w, c), t.stride()[1:], (w * c, c, 1)):
        if size > 1 and stride != want:
            raise ValueError(f"{fn} takes {name} dense over (H, W, C), got strides {t.stride()}")


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
    out = torch.empty((b, h, w, _steps(max_displacement, stride2) ** 2), dtype=torch.float32, device=f1.device)
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


def cost_volume_backward_plain(
    g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, max_displacement: int, stride2: int = 1
):
    """The adjoint of `cost_volume` in torch ops (not autograd): given g
    (B, H, W, D), the gradients (gf1, gf2) of f1, f2 (B, H, W, C),

      gf1[b, y, x, c] = sum_d g[b, y, x, d] * f2[b, y+oy, x+ox, c] / C
      gf2[b, y, x, c] = sum_d g[b, y-oy, x-ox, d] * f1[b, y-oy, x-ox, c] / C

    with (oy, ox) displacement d's offset and every term outside the image
    zero.  One shifted product per displacement, summed in the order of d,
    then divided by C, as the kernel sums."""
    _, h, w, c = f1.shape
    s, pad = max_displacement // stride2, max_displacement
    f2p = F.pad(f2, (0, 0, pad, pad, pad, pad))
    gf1 = torch.zeros_like(f1, memory_format=torch.contiguous_format)
    gf2p = torch.zeros_like(f2p)
    steps = _steps(max_displacement, stride2)
    for iy in range(steps):
        for ix in range(steps):
            oy, ox = (iy - s) * stride2, (ix - s) * stride2
            gd = g[..., iy * steps + ix, None]
            gf1 += gd * f2p[:, pad + oy : pad + oy + h, pad + ox : pad + ox + w]
            gf2p[:, pad + oy : pad + oy + h, pad + ox : pad + ox + w] += gd * f1
    return gf1 / c, gf2p[:, pad : pad + h, pad : pad + w].contiguous() / c


def _launch_backward(g, g2, f1, f2, f3, gf1, gf2, gf3, max_displacement, stride2, pair):
    b, h, w, c = f1.shape
    pl = plan_backward(b, h, w, c, max_displacement, stride2, aligned(f1, f2, f3), pair)
    fn = _library().cost_volume_backward_launch
    with torch.cuda.device(f1.device):
        err = fn(
            g.data_ptr(), g2.data_ptr(), f1.data_ptr(), f2.data_ptr(), f3.data_ptr(), gf1.data_ptr(), gf2.data_ptr(),
            gf3.data_ptr(), f1.stride(0), f2.stride(0), f3.stride(0), b, h, w, c, max_displacement, stride2, int(pair),
            pl.r, pl.gx, pl.gy, pl.slab, pl.threads, pl.copy, pl.smem, pl.grid[0], pl.grid[1] // (4 if pair else 2),
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"cost_volume_backward launch failed with CUDA error {err} ({pl})")
    cost_volume_backward.launches += 1


def _check_backward(gs, fs, max_displacement, stride2):
    plain = "ops/correlation_kernel.py:cost_volume_backward_plain"
    for i, f in enumerate(fs):
        _check(f"f{i + 1}", f, "cost_volume_backward", plain)
    if any(f.shape != fs[0].shape or f.device != fs[0].device for f in fs):
        raise ValueError(f"cost_volume_backward takes frames of one shape and device, got "
                         f"{[(tuple(f.shape), str(f.device)) for f in fs]}")
    if max_displacement < 0 or stride2 < 1:
        raise ValueError(f"cost_volume_backward takes d >= 0 and stride2 >= 1, got {max_displacement}, {stride2}")
    b, h, w, _ = fs[0].shape
    d = _steps(max_displacement, stride2) ** 2
    for g in gs:
        if (g.device != fs[0].device or g.dtype != torch.float32 or tuple(g.shape) != (b, h, w, d)
                or not g.is_contiguous()):
            raise ValueError(f"cost_volume_backward takes g ({b}, {h}, {w}, {d}) float32, contiguous, on "
                             f"{fs[0].device}; got {tuple(g.shape)} {g.dtype} on {g.device}, strides {g.stride()}")


def cost_volume_backward(
    g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, max_displacement: int, stride2: int = 1
):
    """The adjoint of `cost_volume` on the card: (gf1, gf2), each (B, H, W,
    C) float32, contiguous, as `cost_volume_backward_plain` computes them.

    g: (B, H, W, D) float32, contiguous (autograd may hand a strided one:
    the caller makes it contiguous); f1, f2: `cost_volume`'s inputs, read
    with their batch strides.  One launch writes both gradients, cut as
    `plan_backward` says; launches on the current stream and does not
    synchronise; `cost_volume_backward.launches` counts launches."""
    _check_backward((g,), (f1, f2), max_displacement, stride2)
    gf1 = torch.empty(f1.shape, dtype=torch.float32, device=f1.device)
    gf2 = torch.empty_like(gf1)
    _launch_backward(g, g, f1, f2, f1, gf1, gf2, gf1, max_displacement, stride2, False)
    return gf1, gf2


cost_volume_backward.launches = 0


def cost_volume_pair_backward_plain(
    ga: torch.Tensor, gb: torch.Tensor, window: torch.Tensor, max_displacement: int, stride2: int = 1
) -> torch.Tensor:
    """The adjoint of the two volumes (frame 0, frame 1) and (frame 2,
    frame 1) of a (B, 3, H, W, C) window, given their gradients ga, gb: the
    window's gradient (B, 3, H, W, C), frame 1's the sum of both volumes'
    gf2, in torch ops (`cost_volume_backward_plain` twice)."""
    gf_a, gm_a = cost_volume_backward_plain(ga, window[:, 0], window[:, 1], max_displacement, stride2)
    gf_b, gm_b = cost_volume_backward_plain(gb, window[:, 2], window[:, 1], max_displacement, stride2)
    return torch.stack([gf_a, gm_a + gm_b, gf_b], dim=1)


def cost_volume_pair_backward(
    ga: torch.Tensor, gb: torch.Tensor, window: torch.Tensor, max_displacement: int, stride2: int = 1
) -> torch.Tensor:
    """`cost_volume_pair_backward_plain` on the card, in one launch of the
    adjoint kernel: the window's gradient (B, 3, H, W, C) float32,
    contiguous, written whole (frame 1's as gf2 of the first volume plus gf2
    of the second, added in the kernel).

    ga, gb: (B, H, W, D) float32, contiguous; window: (B, 3, H, W, C)
    float32, each frame dense over (H, W, C).  Launches on the current
    stream and does not synchronise; counted in
    `cost_volume_backward.launches`."""
    if window.dim() != 5 or window.shape[1] != 3:
        raise ValueError(f"cost_volume_pair_backward takes a (B, 3, H, W, C) window, got {tuple(window.shape)}")
    fa, fm, fb = window.unbind(1)
    _check_backward((ga, gb), (fa, fm, fb), max_displacement, stride2)
    out = torch.empty(window.shape, dtype=torch.float32, device=window.device)
    _launch_backward(ga, gb, fa, fm, fb, out[:, 0], out[:, 1], out[:, 2], max_displacement, stride2, True)
    return out
