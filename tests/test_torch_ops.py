"""The port's ops against the JAX package's, on the CPU: anchors, box math,
input normalisation and the plain greedy NMS (against the XLA scan and the
Pallas kernel in interpret mode); a NumPy model of the NMS kernels' block
walk (csrc/nms.cu, word by word) against both, and `postprocess` over all
(box, class) pairs; the kernel wrappers' CPU guards, the NMS kernels' plan
and the cost-volume kernel's work plan.  Inputs are made with numpy from a
seed and handed to both.  The correlation op is held against JAX in
tests/test_torch_temporal.py."""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from videoyolo_tpu.data.transforms import to_normalized as jax_to_normalized
from videoyolo_tpu.ops import anchors as jax_anchors
from videoyolo_tpu.ops import bbox as jax_bbox
from videoyolo_tpu.ops.nms import _nms_single as jax_nms_single
from videoyolo_tpu.models import yolo3 as jyolo3
from videoyolo_tpu.ops.pallas_nms import nms_scan_pallas
from videoyolo_torch.data.transforms import to_normalized
from videoyolo_torch.models import yolo3
from videoyolo_torch.ops import anchors, bbox, correlation_kernel, nms_kernel
from videoyolo_torch.ops.correlation_kernel import cost_volume
from videoyolo_torch.ops.nms import _candidates, _nms_single, box_nms, nms_greedy_plain
from videoyolo_torch.ops.nms_kernel import nms_greedy

torch.set_num_threads(2)


def _boxes(rs, shape, scale=50.0):
    xy = rs.rand(*shape, 2).astype(np.float32) * scale
    wh = rs.rand(*shape, 2).astype(np.float32) * 0.8 * scale + 5
    return np.concatenate([xy, xy + wh], -1)


def _sorted_candidates(b, k, n_classes, seed):
    """(B, K, 6) rows in descending, tie-free score order."""
    rs = np.random.RandomState(seed)
    scores = np.sort(rs.rand(b, k))[:, ::-1].astype(np.float32)
    ids = rs.randint(0, n_classes, (b, k)).astype(np.float32)
    return np.concatenate([ids[..., None], scores[..., None], _boxes(rs, (b, k))], -1)


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (13, 13)])
def test_grid_offsets(hw):
    ours = anchors.grid_offsets(*hw, "cpu").numpy()
    np.testing.assert_allclose(ours, jax_anchors.grid_offsets(*hw), rtol=0, atol=1e-6)
    assert anchors.DEFAULT_ANCHORS == jax_anchors.DEFAULT_ANCHORS
    assert anchors.DEFAULT_STRIDES == jax_anchors.DEFAULT_STRIDES


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_pairwise_iou(offset):
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, (2, 7)), _boxes(rs, (2, 5))
    a[0, 0] = b[0, 0]  # identical pair: IoU 1
    ours = bbox.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b), offset=offset).numpy()
    ref = np.asarray(jax_bbox.pairwise_iou(jnp.asarray(a), jnp.asarray(b), offset=offset))
    assert ours.shape == (2, 7, 5)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_corner_center_roundtrip():
    rs = np.random.RandomState(1)
    a = _boxes(rs, (3, 4))
    for ours_fn, ref_fn in (
        (bbox.corner_to_center, jax_bbox.corner_to_center),
        (bbox.center_to_corner, jax_bbox.center_to_corner),
    ):
        ours = ours_fn(torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(ours, np.asarray(ref_fn(jnp.asarray(a))), rtol=1e-6, atol=1e-6)
    parts = bbox.corner_to_center(torch.from_numpy(a), split=True)
    assert len(parts) == 4 and parts[0].shape == (3, 4, 1)


def test_to_normalized_bit_equal():
    img = np.random.RandomState(2).randint(0, 256, (2, 5, 6, 3)).astype(np.uint8)
    ours = to_normalized(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(ours, jax_to_normalized(img))
    assert to_normalized(torch.from_numpy(img), dtype=torch.bfloat16).dtype == torch.bfloat16


def _jax_nms(dets, thresh, valid, topk, post, force, presorted):
    fn = lambda d: jax_nms_single(d, thresh, valid, topk, post, force, presorted)  # noqa: E731
    return np.asarray(jax.vmap(fn)(jnp.asarray(dets)))


# (name, topk, post_nms, force_suppress, presorted, mutate)
NMS_CASES = [
    ("presorted", -1, 100, False, True, None),
    ("presorted_all_rows", -1, -1, False, True, None),
    ("force_suppress", -1, 100, True, True, None),
    ("below_valid_thresh", -1, -1, False, True, "low_scores"),
    ("negative_ids", -1, 100, False, True, "neg_ids"),
    ("identical_boxes", -1, -1, False, True, "identical"),
    ("topk_unsorted", 30, 20, False, False, "shuffle"),
    ("topk_force_invalid", 25, -1, True, False, "shuffle_low"),
]


def _case_dets(mutate, seed=0):
    dets = _sorted_candidates(3, 45, 4, seed)
    rs = np.random.RandomState(seed + 100)
    if mutate in ("low_scores", "shuffle_low"):
        dets[:, -8:, 1] = 0.001  # below valid_thresh
        dets[:, 3, 1] = 0.01  # exactly at it: invalid (strict >)
    if mutate == "neg_ids":
        dets[:, ::5, 0] = -1.0
    if mutate == "identical":
        dets[:, :, 2:6] = dets[:, :1, 2:6]
    if mutate in ("shuffle", "shuffle_low"):
        dets = dets[:, rs.permutation(dets.shape[1])]
    return np.ascontiguousarray(dets)


M32 = (1 << 32) - 1
POISON = 0xDEADBEEFDEADBEEF  # what torch.empty may leave in the words no CTA writes


def _tile_of(tile, w):
    """The mask CTA's (row block, column block >= row block) from its index
    in the upper triangle of W x W tiles, as csrc/nms.cu decodes it."""
    def start(r):
        return r * w - r * (r - 1) // 2

    w2 = 2.0 * w + 1.0
    rb = max(0, min(int((w2 - math.sqrt(w2 * w2 - 8.0 * tile)) * 0.5), w - 1))
    while rb > 0 and start(rb) > tile:
        rb -= 1
    while rb + 1 < w and start(rb + 1) <= tile:
        rb += 1
    return rb, rb + tile - start(rb)


def _pack_words(bits):
    """(..., 64 * W) bool -> (..., W) uint64, bit c of word w = column 64 w + c."""
    return np.packbits(bits, axis=-1, bitorder="little").view("<u8")


def _mask_words(top, thresh, force):
    """The mask launch: each CTA of the plan's grid builds the (B, K, W)
    uint64 suppress words of its 64x64 tile in float32 with the kernel's
    order of operations; the words no CTA writes keep POISON."""
    b, k, _ = top.shape
    pl = nms_kernel.plan(b, k)
    w, blk = pl.words, nms_kernel.BLOCK
    ids, x1, y1, x2, y2 = (top[..., c] for c in (0, 2, 3, 4, 5))
    area = np.maximum(x2 - x1, np.float32(0)) * np.maximum(y2 - y1, np.float32(0))
    mask = np.full((b, k, w), POISON, np.uint64)
    tiles = [_tile_of(t, w) for t in range(pl.mask_grid[0])]
    assert tiles == [(r, c) for r in range(w) for c in range(r, w)]  # each tile once
    for rb, cb in tiles:
        rows, cols = slice(rb * blk, (rb + 1) * blk), slice(cb * blk, (cb + 1) * blk)
        iw = np.maximum(np.minimum(x2[:, rows, None], x2[:, None, cols])
                        - np.maximum(x1[:, rows, None], x1[:, None, cols]), np.float32(0))
        ih = np.maximum(np.minimum(y2[:, rows, None], y2[:, None, cols])
                        - np.maximum(y1[:, rows, None], y1[:, None, cols]), np.float32(0))
        inter = iw * ih
        union = np.maximum(area[:, rows, None] + area[:, None, cols] - inter, np.float32(1e-15))
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(inter > 0, inter / union, np.float32(0))  # the division skipped at 0
        bits = iou > np.float32(thresh)
        if not force:
            bits &= ids[:, rows, None] == ids[:, None, cols]
        if rb == cb:
            bits &= np.triu(np.ones(bits.shape[1:], bool), 1)  # j > i only
        pad = np.zeros(bits.shape[:2] + (blk,), bool)
        pad[..., : bits.shape[2]] = bits  # columns past K stay 0
        mask[:, rows, cb] = _pack_words(pad)[..., 0]
    return mask


def _block_walk(top, thresh, valid_thresh, post_nms, force):
    """A NumPy model of the NMS kernels (csrc/nms.cu), word by word: the
    mask launch, then per image the scan launch's walk over 64-row blocks
    (the block's keep word resolved against its diagonal words in 32-bit
    halves, then the kept rows' later words cleared from the alive words)
    and its popcount-prefix pack.  Returns (packed (B, M, 6), keep (B, K)
    bool)."""
    b, k, _ = top.shape
    mask = _mask_words(top, thresh, force)
    w, blk = mask.shape[2], nms_kernel.BLOCK
    m = min(post_nms, k) if post_nms > 0 else k
    valid = np.zeros((b, w * blk), bool)
    valid[:, :k] = (top[..., 1] > np.float32(valid_thresh)) & (top[..., 0] >= 0)
    packed = np.full((b, m, 6), -1, np.float32)
    keep = np.zeros((b, k), bool)
    for img in range(b):
        alive = [int(v) for v in _pack_words(valid[img])]
        for rb in range(w):
            diag = [int(mask[img, rb * blk + t, rb]) if rb * blk + t < k else 0 for t in range(blk)]
            assert all(d & ((2 << t) - 1) == 0 for t, d in enumerate(diag))  # bits j <= i are 0
            lo, hi = alive[rb] & M32, alive[rb] >> 32
            for t in range(32):
                if (lo >> t) & 1:
                    lo &= ~diag[t] & M32
                    hi &= ~(diag[t] >> 32) & M32
            for t in range(32, blk):
                if (hi >> (t - 32)) & 1:
                    hi &= ~(diag[t] >> 32) & M32
            kept = hi << 32 | lo
            alive[rb] = kept
            rows = [rb * blk + t for t in range(blk) if (kept >> t) & 1]
            if rows and rb + 1 < w:
                later = np.bitwise_or.reduce(mask[img, rows, rb + 1:], axis=0)
                alive[rb + 1:] = [a & ~int(v) for a, v in zip(alive[rb + 1:], later)]
        offset = np.concatenate([[0], np.cumsum([bin(a).count("1") for a in alive])])
        for j in range(k):
            word, bit = alive[j >> 6], j & 63
            if (word >> bit) & 1:
                keep[img, j] = True
                slot = offset[j >> 6] + bin(word & ((1 << bit) - 1)).count("1")
                if slot < m:
                    packed[img, slot] = top[img, j]
    return packed, keep


@pytest.mark.parametrize("case", NMS_CASES, ids=[c[0] for c in NMS_CASES])
def test_plain_nms_matches_jax(case):
    _, topk, post, force, presorted, mutate = case
    dets = _case_dets(mutate)
    ours, keep = _nms_single(torch.from_numpy(dets), 0.45, 0.01, topk, post, force, presorted)
    ref = _jax_nms(dets, 0.45, 0.01, topk, post, force, presorted)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the kernels' block walk on the same candidates
    top = _candidates(torch.from_numpy(dets), 0.01, topk, presorted).numpy()
    walked, walked_keep = _block_walk(top, 0.45, 0.01, post, force)
    np.testing.assert_array_equal(walked, ref)
    np.testing.assert_array_equal(walked_keep, keep.numpy())
    # box_nms on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        box_nms(torch.from_numpy(dets), 0.45, 0.01, topk, post, force, presorted).numpy(), ref
    )
    assert keep.dtype == torch.bool and keep.shape == (3, topk if topk > 0 else 45)
    if post <= 0:  # every kept row is in the output
        assert (keep.sum(1).numpy() == (ref[..., 0] >= 0).sum(1)).all()


@pytest.mark.parametrize("force", [False, True])
def test_plain_nms_keep_matches_pallas_kernel(force):
    dets = _case_dets("low_scores", seed=3)
    dets[:, 1::7, 0] = -1.0
    ref_keep = np.asarray(
        nms_scan_pallas(jnp.asarray(dets), force_suppress=force, interpret=True)
    )
    packed, keep = nms_greedy_plain(torch.from_numpy(dets), 0.45, 0.01, -1, force)
    np.testing.assert_array_equal(keep.numpy(), ref_keep > 0)
    kept_rows = [dets[b][ref_keep[b] > 0] for b in range(dets.shape[0])]
    for b, rows in enumerate(kept_rows):
        np.testing.assert_array_equal(packed[b, : len(rows)].numpy(), rows)
        assert (packed[b, len(rows):].numpy() == -1).all()


def test_plain_nms_single_row_and_thresholds():
    dets = _sorted_candidates(2, 1, 3, 4)
    packed, keep = nms_greedy_plain(torch.from_numpy(dets), 0.45, 0.01, 100, False)
    assert packed.shape == (2, 1, 6) and keep.all()
    np.testing.assert_array_equal(packed.numpy(), dets)
    # IoU exactly at the threshold does not suppress (strict >): two boxes
    # of area 2 overlapping in area 1 have IoU 1/3
    two = np.array([[[0, 0.9, 0, 0, 2, 1], [0, 0.8, 1, 0, 3, 1]]], np.float32)
    _, keep = nms_greedy_plain(torch.from_numpy(two), float(np.float32(1 / 3)), 0.01, -1, False)
    ref = _jax_nms(two, float(np.float32(1 / 3)), 0.01, -1, -1, False, True)
    assert keep.numpy().tolist() == [[True, True]] and (ref[0, :, 0] >= 0).all()


# (K, post_nms): ragged last blocks of 45 - 64 * 0, 16, 1 and 52 rows
WALK_CASES = [(400, 100), (1025, -1), (2100, 300)]


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("k,post", WALK_CASES, ids=[f"K{k}" for k, _ in WALK_CASES])
def test_block_walk_matches_plain_and_jax(k, post, force):
    """The kernels' block walk above one 64-row block and above the old
    1,024-row cap: keep mask and packed rows equal to the plain version's
    and the JAX package's, on 3 classes (many same-class overlaps), with
    negative ids and rows below the valid threshold among them; the boxes
    spread so that an image keeps some and suppresses some."""
    rs = np.random.RandomState(k)
    dets = _sorted_candidates(2, k, 3, seed=k)
    dets[..., 2:6] = _boxes(rs, (2, k), scale=50.0 * math.sqrt(k / 45))
    dets[:, 5::11, 0] = -1.0
    dets[:, -7:, 1] = 0.001
    walked, walked_keep = _block_walk(dets, 0.45, 0.01, post, force)
    packed, keep = nms_greedy_plain(torch.from_numpy(dets), 0.45, 0.01, post, force)
    np.testing.assert_array_equal(walked_keep, keep.numpy())
    np.testing.assert_array_equal(walked, packed.numpy())
    np.testing.assert_array_equal(walked, _jax_nms(dets, 0.45, 0.01, -1, post, force, True))
    valid = ((dets[..., 1] > np.float32(0.01)) & (dets[..., 0] >= 0)).sum(1)
    assert (walked_keep.sum(1) > 0).all() and (walked_keep.sum(1) < valid).all()


def test_block_walk_exact_threshold():
    """IoU exactly at the threshold does not suppress in the block walk
    either: two boxes of area 2 overlapping in area 1, IoU 1/3."""
    two = np.array([[[0, 0.9, 0, 0, 2, 1], [0, 0.8, 1, 0, 3, 1]]], np.float32)
    packed, keep = _block_walk(two, float(np.float32(1 / 3)), 0.01, -1, False)
    assert keep.tolist() == [[True, True]]
    np.testing.assert_array_equal(packed, two)
    _, keep = _block_walk(two, float(np.nextafter(np.float32(1 / 3), np.float32(0))), 0.01, -1, False)
    assert keep.tolist() == [[True, False]]


def test_postprocess_all_pairs_matches_jax():
    """`postprocess(nms_topk=-1)` takes every (box, class) pair as a
    candidate: at 32 px with 20 classes, 63 x 20 = 1,260, above the old
    1,024-row cap of the NMS kernel.  The port's equals the JAX package's on
    the outputs of a JAX YOLOv3 head (routes of a 32-px image, random
    weights), whose scores hold no ties (the top-k is exact modulo ties):
    its kernels at gain 1.4 spread the scores over (0, 1), where at gain 1
    they crowd [0.18, 0.32] and two of 1,260 tie."""
    rs = np.random.RandomState(21)
    routes = [rs.randn(2, s, s, c).astype(np.float32) for s, c in ((4, 32), (2, 32), (1, 64))]
    head = jyolo3.YOLOv3(num_classes=20, use_backbone=False, channels=(32, 16, 8))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 1.4 if path[-1].key == "kernel" else v,
        head.init(jax.random.PRNGKey(0), routes, train=False),
    )
    boxes, scores = (np.array(a) for a in jax.jit(partial(head.apply, train=False))(variables, routes))
    assert boxes.shape == (2, 63, 4) and scores.shape == (2, 63, 20)
    assert all(len(np.unique(s)) == s.size for s in scores)  # tie-free
    ours = yolo3.postprocess(torch.from_numpy(boxes), torch.from_numpy(scores), nms_topk=-1, post_nms=-1)
    ref = jyolo3.postprocess(jnp.asarray(boxes), jnp.asarray(scores), nms_topk=-1, post_nms=-1)
    for a, r in zip(ours, ref):
        assert a.shape == (2, 1260, a.shape[-1])
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    kept = (ours[0].numpy() >= 0).sum(axis=(1, 2))
    assert (kept > 0).all() and (kept < 1260).all()


# (B, K, (W, tiles, workspace bytes)): the main path, its B=1, the 64-px
# all-pairs postprocess, one row, K = 8,192 at B=1
NMS_PLANS = [(128, 400, (7, 28, 2_867_200)), (1, 400, (7, 28, 22_400)), (2, 5040, (79, 3160, 6_370_560)),
             (4, 1, (1, 1, 32)), (1, 8192, (128, 8256, 8_388_608))]


@pytest.mark.parametrize("b,k,want", NMS_PLANS, ids=[f"B{b}_K{k}" for b, k, _ in NMS_PLANS])
def test_nms_plan(b, k, want):
    """The NMS kernels' plan, held here, where no card is (the C entry
    points refuse another): W = ceil(K/64) words a row, the upper triangle's
    W(W+1)/2 mask CTAs an image, one scan CTA an image with 12 bytes of
    shared memory a word, the (B, K, W) uint64 workspace."""
    pl = nms_kernel.plan(b, k)
    assert (pl.words, pl.tiles, pl.workspace) == want
    assert pl.words * 64 >= k > (pl.words - 1) * 64
    assert pl.mask_grid == (pl.tiles, b) and pl.scan_grid == b
    assert pl.scan_smem == 12 * pl.words <= 48 * 1024


def test_nms_plan_refuses_past_the_workspace_limit():
    """K is bounded only by the workspace: 4 GiB of suppress words holds
    K = 185,344 at B = 1 and 16,384 at B = 128; one more raises a
    ValueError that names the bytes."""
    assert nms_kernel.WORKSPACE_LIMIT == 1 << 32
    assert nms_kernel.plan(1, 185_344).workspace <= 1 << 32
    assert nms_kernel.plan(128, 16_384).workspace == 1 << 32
    with pytest.raises(ValueError, match=r"needs 4312007680 bytes of suppress words .* 4294967296-byte limit"):
        nms_kernel.plan(128, 16_385)
    with pytest.raises(ValueError, match="bytes of suppress words"):
        nms_kernel.plan(1, 185_345)
    with pytest.raises(ValueError, match="B <= 65535"):
        nms_kernel.plan(65_536, 1)


def test_kernel_entry_raises_on_cpu_tensor():
    dets = torch.from_numpy(_sorted_candidates(1, 8, 2, 5))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nms_greedy(dets)
    assert nms_greedy.launches == 0
    f = torch.zeros(2, 5, 6, 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cost_volume(f, f, 2)
    assert cost_volume.launches == 0


def _ceil_div(a, b):
    return -(-a // b)


def _assert_corr_plan(b, h, w, c, d, stride2, aligned=True):
    """The cost-volume kernel's plan for one launch, held here, where no
    card is (the C entry point refuses a plan that does not match): the
    register tile and group are instances the kernel has, each CTA's
    displacements are one run of output channels, the staged chunk and the
    staged results fit the shared memory asked for, and the grid covers the
    image and the displacement grid."""
    k = correlation_kernel
    pl = k.plan(b, h, w, c, d, stride2, aligned)
    steps = 2 * (d // stride2) + 1
    assert (pl.r, pl.gy, pl.threads // 32) in [cand[:3] for cand in k.CANDIDATES] and pl.threads % 32 == 0
    assert (pl.r == 1 or stride2 == 1) and pl.nacc == pl.r * pl.gx * pl.gy
    assert pl.gx in k.GROUP_X and pl.gx <= steps and pl.gy <= steps
    rows, cols = pl.tile
    assert (rows, cols) == (k.ROWS, 4 * pl.r * pl.threads // 32)
    assert pl.copy == (16 if aligned and c % 4 == 0 else 4)
    # the staged chunk: the f1 tile and the f2 window, 16 channels a pixel,
    # rows padded by 16 bytes; the staged results: a run of the group per pixel
    win_h, win_w = rows + (pl.gy - 1) * stride2, cols + (pl.gx - 1) * stride2
    staged = (rows * (cols * k.CHUNK + 4) + win_h * (win_w * k.CHUNK + 4)) * 4
    assert pl.smem == max(staged, rows * cols * (pl.gx * pl.gy | 1) * 4) <= k.SMEM_BYTES
    tiles_y, tiles_x = _ceil_div(h, rows), _ceil_div(w, cols)
    assert tiles_y * rows >= h and tiles_x * cols >= w
    assert pl.grid == (tiles_y * tiles_x, _ceil_div(steps, pl.gx) * _ceil_div(steps, pl.gy), b)
    assert pl.grid[1] <= k.MAX_GROUPS and pl.ctas == pl.grid[0] * pl.grid[1] * b
    assert pl.live == pytest.approx(h * w / (tiles_y * rows * tiles_x * cols))
    # every group: its displacements are one run of output channels, and the
    # groups cover the grid once
    covered = []
    for iy0 in range(0, steps, pl.gy):
        for ix0 in range(0, steps, pl.gx):
            chans = [iy * steps + ix for iy in range(iy0, min(iy0 + pl.gy, steps))
                     for ix in range(ix0, min(ix0 + pl.gx, steps))]
            assert chans == list(range(chans[0], chans[0] + len(chans)))
            covered += chans
    assert sorted(covered) == list(range(steps * steps))
    return pl


@pytest.mark.parametrize("d,stride2", [(0, 1), (1, 1), (2, 1), (4, 1), (4, 2), (20, 2), (20, 1),
                                       (40, 1), (7, 3), (500, 250)])
def test_cost_volume_plan(d, stride2):
    """The plan at the 26x26x512 level of a B=32 request, for displacements
    and strides the kernel takes."""
    pl = _assert_corr_plan(32, 26, 26, 512, d, stride2)
    if (d, stride2) == (4, 1):  # the main path: 3 groups of 3 dy rows
        assert (pl.r, pl.gx, pl.gy, pl.nacc) == (2, 9, 3, 54)


# the main path's levels at B=32, d=4: (H = W, C) and the plan's (R, gx, gy,
# tile, threads, grid)
CORR_LEVELS = [
    (52, 256, (2, 9, 3, (8, 8), 32, (49, 3, 32))),
    (26, 512, (2, 9, 3, (8, 8), 32, (16, 3, 32))),
    (13, 1024, (1, 9, 3, (8, 8), 64, (4, 3, 32))),
]


@pytest.mark.parametrize("h,c,want", CORR_LEVELS, ids=["52x52x256", "26x26x512", "13x13x1024"])
def test_cost_volume_plan_of_main_path(h, c, want):
    """Each level of the main path gets at least two CTAs an SM of an H100
    (264) and keeps at least half of its pixel slots inside the image, with
    16-byte copies."""
    pl = _assert_corr_plan(32, h, h, c, 4, 1)
    assert pl.ctas >= correlation_kernel.MIN_CTAS == 264 and pl.live >= 0.5
    assert (pl.r, pl.gx, pl.gy, pl.tile, pl.threads, pl.grid) == want and pl.copy == 16


@pytest.mark.parametrize("name,b,h,w,c,d,stride2", chip_smoke.CORR_CASES,
                         ids=[case[0] for case in chip_smoke.CORR_CASES])
def test_cost_volume_plan_of_card_cases(name, b, h, w, c, d, stride2):
    """The cases chip_smoke.py holds against the plain version get a plan
    the kernel takes."""
    _assert_corr_plan(b, h, w, c, d, stride2)


def test_cost_volume_copies_narrow_on_misalignment():
    """16-byte copies need C % 4 == 0 and 16-byte aligned pointers and batch
    strides; anything else takes 4-byte copies (the same tile)."""
    k = correlation_kernel
    window = torch.zeros(2, 3, 5, 5, 8)
    assert k.aligned(window[:, 0], window[:, 1])
    flat = torch.zeros(2 * 5 * 5 * 8 + 1)
    assert not k.aligned(flat[1:].view(2, 5, 5, 8))
    assert not k.aligned(torch.zeros(2 * 101).as_strided((2, 5, 5, 4), (101, 20, 4, 1)))  # batch stride 101
    assert k.aligned(torch.zeros(1, 5, 5, 6))  # one image: its batch stride is never used
    shape = (32, 52, 52, 256, 4, 1)
    assert k.plan(*shape)._replace(copy=4) == k.plan(*shape, aligned=False)
    assert _assert_corr_plan(4, 20, 20, 6, 4, 1).copy == 4
