"""The work plan of K2's adjoint kernel (`correlation_kernel.plan_backward`),
held here, where no card is: the C entry point refuses a plan that does not
match its shapes, so what it launches is what these tests pin.

Each plan is checked for what the kernel (`csrc/correlation.cu`,
`cost_volume_backward_kernel`) takes: an instance it was built for, tiles
and slabs that cover every pixel and channel once, displacement groups that
cover the grid once and in order, and staged windows and g tiles that fit
the shared memory asked for.  `_walk` follows the kernel's walk over a
plan (tile, gradient, slab, 16-channel chunk, displacement group, staged
window and staged g, gf2's reversed columns) in torch ops: it must equal the
plain adjoint bit for bit (the same products, added in the same order of
d), signed zeros aside.  The CUDA source itself is also built here, by g++
against a CPU stand-in for the CUDA names it uses
(`tests/cuda_cpu/cuda_on_cpu.h`), and run at small shapes through its C
entry points."""
import re
import subprocess
from pathlib import Path

import chip_smoke
import pytest
import torch
from torch.nn import functional as F

from videoyolo_torch.ops import correlation_kernel as k
from videoyolo_torch.ops.correlation import correlation_plain
from videoyolo_torch.ops.correlation_kernel import cost_volume_backward_plain, plan_backward

torch.set_num_threads(2)


def _ceil_div(a, b):
    return -(-a // b)


def _assert_backward_plan(b, h, w, c, d, stride2, aligned=True, pair=False):
    pl = plan_backward(b, h, w, c, d, stride2, aligned, pair)
    roles = 4 if pair else 2  # the pair: gf_a, gf_b and two halves of gf_m's slab
    steps = 2 * (d // stride2) + 1
    # an instance the kernel has: R, the displacement columns, the threads
    assert pl.r in k.BACKWARD_R and (pl.r == 1 or stride2 == 1)
    assert (pl.r, pl.threads // 16) in k.BACKWARD_CANDIDATES and pl.threads % 32 == 0
    assert pl.gx in k.GROUP_X and pl.gx <= steps and 1 <= pl.gy <= steps and (pl.gy == 1 or pl.gx == steps)
    rows, cols = pl.tile
    assert (rows, cols) == (k.ROWS, pl.r * pl.threads // 16) == (8, 8)
    assert pl.copy == (16 if aligned and c % 4 == 0 else 4)
    # the staged window (rows padded by 16 bytes) and the tile's g fit
    win_h, win_w = rows + (pl.gy - 1) * stride2, cols + (pl.gx - 1) * stride2
    dg = _ceil_div(pl.gx * pl.gy + 4, 8) * 8 - 4
    assert dg >= pl.gx * pl.gy and dg % 8 == 4
    assert pl.smem == (win_h * (win_w * k.CHUNK + 4) + rows * (cols * dg + 1)) * 4 <= k.SMEM_BYTES
    # tiles cover the image, slabs the channels, each once
    tiles_y, tiles_x = _ceil_div(h, rows), _ceil_div(w, cols)
    slabs = pl.grid[1] // roles
    assert pl.grid == (tiles_y * tiles_x, roles * slabs, b)
    covered = torch.zeros(h, w, c, dtype=torch.int64)
    for t in range(pl.grid[0]):
        y0, x0 = t // tiles_x * rows, t % tiles_x * cols
        for sl in range(slabs):
            covered[y0:y0 + rows, x0:x0 + cols, sl * pl.slab:(sl + 1) * pl.slab] += 1
    assert bool((covered == 1).all())
    assert pl.slab % k.CHUNK == 0 and (slabs - 1) * pl.slab < c <= slabs * pl.slab
    assert pl.live == pytest.approx(h * w / (tiles_y * rows * tiles_x * cols))
    # the groups, walked as the kernel walks them, meet every displacement once, in order
    groups_x = _ceil_div(steps, pl.gx)
    order = [(grp // groups_x * pl.gy + jy) * steps + grp % groups_x * pl.gx + jx
             for grp in range(_ceil_div(steps, pl.gy) * groups_x)
             for jy in range(min(pl.gy, steps - grp // groups_x * pl.gy)) for jx in range(pl.gx)
             if grp % groups_x * pl.gx + jx < steps]
    assert order == list(range(steps * steps))
    return pl


def _walk(pl, g, f1, f2, d, stride2):
    """The adjoint as the kernel computes it under plan `pl`, in torch ops
    (multiply, then add, in the kernel's order of d)."""
    b, h, w, c = f1.shape
    steps, s2 = 2 * (d // stride2) + 1, stride2
    s = steps // 2
    rows, cols = pl.tile
    tiles_x, groups_x = _ceil_div(w, cols), _ceil_div(steps, pl.gx)
    win_h, win_w = rows + (pl.gy - 1) * s2, cols + (pl.gx - 1) * s2
    pad = (steps + 9) * s2 + 16
    gp = F.pad(g, (0, 0, pad, pad, pad, pad))
    outs = []
    for flip, part in ((False, f2), (True, f1)):
        pp = F.pad(part, (0, 0, pad, pad, pad, pad))
        out = torch.full((b, h + rows, w + cols, c), float("nan"))
        for t in range(pl.grid[0]):
            y0, x0 = t // tiles_x * rows, t % tiles_x * cols
            for sl in range(pl.grid[1] // 2):
                cs1 = min(c, (sl + 1) * pl.slab)
                for c0 in range(sl * pl.slab, cs1, k.CHUNK):
                    cc = slice(c0, min(c0 + k.CHUNK, cs1))
                    acc = torch.zeros(b, rows, cols, cc.stop - c0)
                    for grp in range(_ceil_div(steps, pl.gy) * groups_x):
                        iy0, ix0 = grp // groups_x * pl.gy, grp % groups_x * pl.gx
                        wy0 = y0 - (iy0 + pl.gy - 1 - s) * s2 if flip else y0 + (iy0 - s) * s2
                        wx0 = x0 - (ix0 + pl.gx - 1 - s) * s2 if flip else x0 + (ix0 - s) * s2
                        win = pp[:, pad + wy0:pad + wy0 + win_h, pad + wx0:pad + wx0 + win_w, cc]
                        for jy in range(min(pl.gy, steps - iy0)):
                            for jx in range(pl.gx):
                                iy, ix = iy0 + jy, ix0 + jx
                                if ix < steps:  # the staged g: the pixel's own, or gf2's shifted
                                    gy0 = y0 - (iy - s) * s2 if flip else y0
                                    gx0 = x0 - (ix - s) * s2 if flip else x0
                                    gt = gp[:, pad + gy0:pad + gy0 + rows, pad + gx0:pad + gx0 + cols, iy * steps + ix]
                                    if not flip:  # g of the tile's pixels outside the image is staged zero
                                        gt = gt * (torch.arange(rows)[:, None] + y0 < h) * (torch.arange(cols) + x0 < w)
                                else:
                                    gt = torch.zeros(b, rows, cols)
                                wr = (pl.gy - 1 - jy if flip else jy) * s2
                                wc = (pl.gx - 1 - jx if flip else jx) * s2
                                acc = acc + gt[..., None] * win[:, wr:wr + rows, wc:wc + cols]
                    out[:, y0:y0 + rows, x0:x0 + cols, cc] = acc / c
        outs.append(out[:, :h, :w])
    return outs


# (d, stride2): displacements and strides the kernel takes, wide grids in groups among them
DISPLACEMENTS = [(0, 1), (1, 1), (2, 1), (4, 1), (4, 2), (5, 1), (20, 2), (20, 1), (40, 1), (7, 3), (500, 250)]


@pytest.mark.parametrize("d,stride2", DISPLACEMENTS)
def test_backward_plan(d, stride2):
    """The plan at the 26x26x512 level of the B=16 train step."""
    pl = _assert_backward_plan(16, 26, 26, 512, d, stride2)
    if (d, stride2) == (4, 1):  # the main path: the whole grid in one group
        assert (pl.r, pl.gx, pl.gy) == (2, 9, 9)


# the train step's levels at d=4: (B, H = W, C) and the plan's (R, slab,
# threads, grid)
BACKWARD_LEVELS = [
    (16, 52, 256, (2, 256, 64, (49, 2, 16))),
    (16, 26, 512, (2, 512, 64, (16, 2, 16))),
    (16, 13, 1024, (2, 256, 64, (4, 8, 16))),
    (1, 52, 256, (2, 48, 64, (49, 12, 1))),
    (1, 26, 512, (2, 32, 64, (16, 32, 1))),
    (1, 13, 1024, (2, 16, 64, (4, 128, 1))),
]


@pytest.mark.parametrize("b,h,c,want", BACKWARD_LEVELS,
                         ids=[f"B{b}_{h}x{h}x{c}" for b, h, c, _ in BACKWARD_LEVELS])
def test_backward_plan_of_main_path(b, h, c, want):
    """Each level of the window train step, at B=16 and at B=1, gives an
    H100 at least two CTAs an SM, and BACKWARD_MIN_CTAS where slabs of one
    chunk allow (C cut into slabs where the tiles alone are too few:
    13x13x1024 has 4 tiles x 16 images x 2 gradients = 128 without a cut),
    16-byte copies, one group of 9x9 displacements, so g is staged once a
    CTA."""
    pl = _assert_backward_plan(b, h, h, c, 4, 1)
    assert pl.ctas >= 2 * k.SMS and (pl.ctas >= k.BACKWARD_MIN_CTAS or pl.slab == k.CHUNK)
    assert (pl.r, pl.slab, pl.threads, pl.grid) == want and (pl.gx, pl.gy, pl.copy) == (9, 9, 16)
    assert pl.smem == 38176  # 16.6 KB of window + 21.5 KB of g: 5 CTAs an SM


@pytest.mark.parametrize("name,b,h,w,c,d,stride2", chip_smoke.CORR_BWD_CASES,
                         ids=[case[0] for case in chip_smoke.CORR_BWD_CASES])
def test_backward_plan_of_card_cases(name, b, h, w, c, d, stride2):
    """The cases chip_smoke.py holds the adjoint to on the card get a plan
    the kernel takes (the misaligned case with 4-byte copies)."""
    pl = _assert_backward_plan(b, h, w, c, d, stride2, aligned=not name.startswith("misaligned"))
    assert plan_backward(b, h, w, c, d, stride2, not name.startswith("misaligned")) == pl


@pytest.mark.parametrize("b,h,c,want", BACKWARD_LEVELS,
                         ids=[f"B{b}_{h}x{h}x{c}" for b, h, c, _ in BACKWARD_LEVELS])
def test_pair_plan_of_main_path(b, h, c, want):
    """The pair launch (the Corr layer's two volumes of a window, three
    gradients) at each level: the one-volume plan's tiling, four roles in
    the grid (gf_a, gf_b and gf_m in two halves of the slab), and C cut for
    their CTAs."""
    pl = _assert_backward_plan(b, h, h, c, 4, 1, pair=True)
    one = plan_backward(b, h, h, c, 4, 1)
    assert (pl.r, pl.gx, pl.gy, pl.tile, pl.threads, pl.copy, pl.smem) == (
        one.r, one.gx, one.gy, one.tile, one.threads, one.copy, one.smem)
    assert pl.ctas >= 2 * k.SMS and (pl.ctas >= k.BACKWARD_MIN_CTAS or pl.slab == k.CHUNK)


def test_pair_entry_refuses_cpu_tensors_and_other_windows():
    window = torch.zeros(2, 3, 5, 6, 4)
    g = torch.zeros(2, 5, 6, 25)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        k.cost_volume_pair_backward(g, g, window, 2)
    with pytest.raises(ValueError, match=r"\(B, 3, H, W, C\) window"):
        k.cost_volume_pair_backward(g, g, torch.zeros(2, 2, 5, 6, 4), 2)
    assert k.cost_volume_backward.launches == 0


def test_backward_card_cases_reach_the_tiling_edges():
    """CORR_BWD_CASES holds ragged tiles in both axes, a C that is no
    multiple of the chunk or of the slab, d = 0, a ragged group, a
    misaligned pair and one image at 13x13x1024."""
    cases = {name: (b, h, w, c, d, s2) for name, b, h, w, c, d, s2 in chip_smoke.CORR_BWD_CASES}
    plans = {name: plan_backward(*case, not name.startswith("misaligned")) for name, case in cases.items()}
    assert any(h % 8 and w % 8 for _, h, w, _, _, _ in cases.values())
    assert any(c % k.CHUNK and c > plans[n].slab and c % plans[n].slab for n, (_, _, _, c, _, _) in cases.items())
    assert any(d == 0 for *_, d, _ in cases.values())
    assert any(_ceil_div(2 * (d // s2) + 1, plans[n].gx) * plans[n].gx > 2 * (d // s2) + 1
               for n, (*_, d, s2) in cases.items())
    assert plans["misaligned_26x26x64"].copy == 4
    assert cases["level3_B1"] == (1, 13, 13, 1024, 4, 1) and plans["level3_B1"].grid[1] // 2 == 64


def test_backward_copies_narrow_on_misalignment():
    """16-byte copies need C % 4 == 0 and 16-byte aligned pointers and batch
    strides; anything else takes 4-byte copies with the same tiling."""
    shape = (16, 52, 52, 256, 4, 1)
    assert plan_backward(*shape)._replace(copy=4) == plan_backward(*shape, aligned=False)
    assert _assert_backward_plan(2, 20, 20, 6, 4, 1).copy == 4
    assert _assert_backward_plan(2, 20, 20, 20, 4, 1).copy == 16
    flat = torch.zeros(2 * 3 * 26 * 26 * 64 + 1)
    window = flat[1:].view(2, 3, 26, 26, 64)
    assert not k.aligned(window[:, 0], window[:, 1])


@pytest.mark.parametrize("args", [
    (0, 8, 8, 16, 4, 1), (1, 0, 8, 16, 4, 1), (1, 8, 0, 16, 4, 1), (1, 8, 8, 0, 4, 1), (1, 8, 8, 16, -1, 1),
    (1, 8, 8, 16, 4, 0), (k.MAX_BATCH + 1, 8, 8, 16, 4, 1),
])
def test_backward_plan_raises_on_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError, match="cost_volume_backward"):
        plan_backward(*args)


def _inputs(seed, b, h, w, c, d, s2):
    gen = torch.Generator().manual_seed(seed)
    window = torch.randn(b, 3, h, w, c, generator=gen)
    return torch.randn(b, h, w, (2 * (d // s2) + 1) ** 2, generator=gen), window[:, 0], window[:, 1]


# (B, H, W, C, d, stride2): ragged tiles, a C of two slabs and a last
# chunk of 4, C = 3, d = 0, a stride2 of 2, a ragged group of 7 columns
WALK_CASES = [(2, 13, 11, 20, 4, 1), (1, 9, 17, 40, 2, 1), (2, 11, 9, 3, 2, 1), (2, 10, 10, 32, 0, 1),
              (1, 19, 18, 16, 4, 2), (1, 14, 15, 16, 5, 1)]


@pytest.mark.parametrize("b,h,w,c,d,s2", WALK_CASES, ids=[f"B{b}_{h}x{w}x{c}_d{d}_s{s}" for b, h, w, c, d, s in WALK_CASES])
def test_kernel_walk_equals_plain_adjoint(b, h, w, c, d, s2):
    """The kernel's walk under its plan equals the plain adjoint bit for
    bit, signed zeros aside (torch.equal counts -0 == +0)."""
    g, f1, f2 = _inputs(b + h + d, b, h, w, c, d, s2)
    pl = _assert_backward_plan(b, h, w, c, d, s2)
    assert pl.grid[1] // 2 > 1 or c <= k.CHUNK  # these small launches are cut into slabs
    for got, want in zip(_walk(pl, g, f1, f2, d, s2), cost_volume_backward_plain(g, f1, f2, d, s2)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("r,groups", k.BACKWARD_CANDIDATES)
@pytest.mark.parametrize("gx,gy,slab", [(9, 9, 16), (9, 3, 32), (5, 1, 48), (3, 1, 16)])
def test_kernel_walk_under_every_tiling(r, groups, gx, gy, slab):
    """Every register tile, displacement groups of whole rows and of part
    rows (ragged: 9 in groups of 5), and slabs of 1 to 3 chunks."""
    g, f1, f2 = _inputs(3, 2, 13, 11, 40, 4, 1)
    pl = k._make_backward(2, 13, 11, 40, 1, r, groups, gx, gy, slab, True)
    for got, want in zip(_walk(pl, g, f1, f2, 4, 1), cost_volume_backward_plain(g, f1, f2, 4, 1)):
        assert torch.equal(got, want)


# --- the CUDA source itself, built for the CPU -------------------------------
# csrc/correlation.cu compiled by g++ against tests/cuda_cpu/cuda_on_cpu.h
# (one OS thread per CUDA thread, cp.async as memcpy, NaN-filled shared
# memory) and called through its C entry points with the plans above: the
# adjoint within 1e-5 of the plain version, the pair launch equal to two
# one-volume launches bit for bit, and the forward within 1e-5 of
# correlation_plain.

def _cpu_source(text: str) -> str:
    def sub(pattern, repl, text, count=1):
        out, n = re.subn(pattern, repl, text, flags=re.S)
        assert n >= count, f"correlation.cu no longer has {pattern!r}"
        return out

    text = sub(re.escape("#include <cuda_runtime.h>"), f'#include "{CUDA_ON_CPU}"', text)
    text = sub(re.escape("extern __shared__ __align__(16) float smem[];"), "float* smem = cuda_on_cpu_smem;", text, 2)
    for width in (16, 4):
        text = sub(rf"(void copy{width}\(float\* dst, const float\* src, bool valid\) \{{).*?\n\}}",
                   rf"\1\n  if (valid) std::memcpy(dst, src, {width}); else std::memset(dst, 0, {width});\n}}", text)
    text = sub(r"(int group_index\(\) \{).*?\n\}", r"\1\n  return blockIdx.y;\n}", text)
    text = sub(re.escape('asm volatile("cp.async.wait_all;\\n" ::: "memory");'), ";", text, 2)
    text = sub(r"(cost_volume\w*kernel<[\w, ]+>)<<<([^>]*)>>>\((\w+)\);", r"cuda_on_cpu_launch(\2, [&] { \1(\3); });",
               text, 2)
    assert "asm" not in text
    return text


CUDA_ON_CPU = Path(__file__).resolve().parent / "cuda_cpu" / "cuda_on_cpu.h"


@pytest.fixture(scope="module")
def cpu_library(tmp_path_factory):
    """The cost-volume library built from csrc/correlation.cu for the CPU,
    bound as `correlation_kernel._library` binds the card's."""
    tmp = tmp_path_factory.mktemp("correlation_cpu")
    src = tmp / "correlation_cpu.cpp"
    src.write_text(_cpu_source(k.SOURCE.read_text()))
    lib = tmp / "libcorrelation_cpu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    build = k.build
    k.build = lambda: (lib, "")
    try:
        return k._library.__wrapped__()
    finally:
        k.build = build


def _cpu_backward(lib, pl, gs, fs, outs, d, s2, pair):
    b, h, w, c = fs[0].shape
    err = lib.cost_volume_backward_launch(
        *(t.data_ptr() for t in (*gs, *fs, *outs)), *(f.stride(0) for f in fs), b, h, w, c, d, s2, int(pair),
        pl.r, pl.gx, pl.gy, pl.slab, pl.threads, pl.copy, pl.smem, pl.grid[0], pl.grid[1] // (4 if pair else 2), None)
    assert err == 0, pl


# (name, B, H, W, C, d, stride2): ragged tiles and a C of a chunk and 4,
# C = 3 (4-byte copies), a stride2 of 2 (R = 1), d = 0, a ragged group of
# displacement columns, frames misaligned by one float
CPU_CASES = [("ragged_d4", 2, 13, 11, 20, 4, 1), ("C3_d2", 2, 11, 9, 3, 2, 1), ("stride2", 1, 19, 18, 16, 4, 2),
             ("d0", 2, 10, 10, 32, 0, 1), ("d5_ragged_group", 1, 14, 15, 16, 5, 1),
             ("misaligned", 2, 10, 12, 32, 4, 1)]


@pytest.mark.parametrize("name,b,h,w,c,d,s2", CPU_CASES, ids=[case[0] for case in CPU_CASES])
def test_adjoint_source_on_the_cpu(cpu_library, name, b, h, w, c, d, s2):
    gen = torch.Generator().manual_seed(len(name))
    n = b * 3 * h * w * c
    window = torch.randn(n + 1, generator=gen)[1:].view(b, 3, h, w, c) if name == "misaligned" else \
        torch.randn(b, 3, h, w, c, generator=gen)
    ga, gb = (torch.randn(b, h, w, (2 * (d // s2) + 1) ** 2, generator=gen) for _ in range(2))
    fa, fm, fb = window.unbind(1)
    aligned = k.aligned(fa, fm, fb)
    one = [torch.full((b, h, w, c), float("nan")) for _ in range(4)]
    _cpu_backward(cpu_library, plan_backward(b, h, w, c, d, s2, aligned), (ga, ga), (fa, fm, fa),
                  (one[0], one[1], one[0]), d, s2, False)
    _cpu_backward(cpu_library, plan_backward(b, h, w, c, d, s2, aligned), (gb, gb), (fb, fm, fb),
                  (one[2], one[3], one[2]), d, s2, False)
    for got, want in zip(one, (*cost_volume_backward_plain(ga, fa, fm, d, s2),
                               *cost_volume_backward_plain(gb, fb, fm, d, s2))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    pair = torch.full(window.shape, float("nan"))
    _cpu_backward(cpu_library, plan_backward(b, h, w, c, d, s2, aligned, pair=True), (ga, gb), (fa, fm, fb),
                  pair.unbind(1), d, s2, True)
    assert torch.equal(pair, torch.stack([one[0], one[1] + one[3], one[2]], dim=1))
    pf = k.plan(b, h, w, c, d, s2, k.aligned(fa, fm))
    out = torch.full((b, h, w, (2 * (d // s2) + 1) ** 2), float("nan"))
    assert cpu_library.cost_volume_launch(fa.data_ptr(), fm.data_ptr(), out.data_ptr(), fa.stride(0), fm.stride(0),
                                          b, h, w, c, d, s2, pf.r, pf.gx, pf.gy, pf.threads, pf.copy, pf.smem,
                                          pf.grid[0], pf.grid[1], None) == 0
    torch.testing.assert_close(out, correlation_plain(fa, fm, d, 1, 1, s2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("slab", [32, 48, 80])
def test_pair_source_halves_of_a_slab_on_the_cpu(cpu_library, slab):
    """The pair's middle-frame CTAs take the two halves of a slab (here 16
    and 16, 32 and 16, 48 and 32 channels of 72)."""
    gen = torch.Generator().manual_seed(slab)
    window = torch.randn(2, 3, 13, 11, 72, generator=gen)
    ga, gb = (torch.randn(2, 13, 11, 81, generator=gen) for _ in range(2))
    pl = k._make_backward(2, 13, 11, 72, 1, 2, 4, 9, 9, slab, True, roles=4)
    pair = torch.full(window.shape, float("nan"))
    _cpu_backward(cpu_library, pl, (ga, gb), window.unbind(1), pair.unbind(1), 4, 1, True)
    torch.testing.assert_close(pair, k.cost_volume_pair_backward_plain(ga, gb, window, 4, 1), rtol=1e-5, atol=1e-5)
