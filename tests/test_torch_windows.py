"""The port's ImageNet-VID windows against the JAX package's on the CPU: the
window sampler and `window_paths` (the clamping cases of tests/test_vid.py
and a whole tree, exact), a window sample, both video transforms, a
shuffled window epoch of the per-sample route against JAX's at
num_workers=1 (labels and colour maps bit for bit, pixels within the
resampler's tolerance of cv2's) and at 4 workers against 1, the inference
route for windows, and mixup on windows, which JAX cannot blend.

The resampler follows cv2 within tests/test_native_train.py's tolerances
(tests/test_torch_pixels.py says which); the frames here are 96x128 noise
written by cv2, which the core decodes bit for bit as cv2 does."""
import os
import random

import cv2
import numpy as np
import pytest
import torch

from test_torch_pixels import EPOCH_TOL
from test_torch_vid import write_vid_tree
from videoyolo_tpu.data.base import load_names
from videoyolo_tpu.data.imgnetvid import ImageNetVidDetection as JaxVID
from videoyolo_tpu.data.loader import DetectionLoader as JaxLoader
from videoyolo_tpu.data.transforms import MixupDetection as JaxMixup
from videoyolo_tpu.data.transforms import YOLO3VideoInferenceTransform as JaxVideoInference
from videoyolo_tpu.data.transforms import YOLO3VideoTrainTransform as JaxVideoTrain
from videoyolo_torch import native
from videoyolo_torch.data.imgnetvid import ImageNetVidDetection
from videoyolo_torch.data.loader import DetectionLoader
from videoyolo_torch.data.prefetch import device_prefetch
from videoyolo_torch.data.transforms import (
    MixupDetection,
    YOLO3VideoInferenceTransform,
    YOLO3VideoTrainTransform,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """tests/test_vid.py's tree: two clips of 8 frames (120x160), one
    moving box a clip."""
    wn = load_names("imagenetvid_wn")
    root = tmp_path_factory.mktemp("ILSVRC")
    (root / "ImageSets" / "VID").mkdir(parents=True)
    lines = []
    for clip_i in range(2):
        clip = f"ILSVRC2017_val_{clip_i:08d}"
        (root / "Data" / "VID" / "val" / clip).mkdir(parents=True)
        (root / "Annotations" / "VID" / "val" / clip).mkdir(parents=True)
        for f in range(8):
            fname = f"{f:06d}"
            cv2.imwrite(str(root / "Data" / "VID" / "val" / clip / f"{fname}.JPEG"), np.zeros((120, 160, 3), np.uint8))
            x1 = 10 + 2 * f + 20 * clip_i
            (root / "Annotations" / "VID" / "val" / clip / f"{fname}.xml").write_text(
                f"<annotation><size><width>160</width><height>120</height></size><object><name>{wn[clip_i]}</name>"
                f"<trackid>0</trackid><bndbox><xmax>{x1 + 40}</xmax><xmin>{x1}</xmin><ymax>90</ymax><ymin>30</ymin>"
                "</bndbox></object></annotation>")
            lines.append(f"{clip}/{fname} {len(lines) + 1}")
    (root / "ImageSets" / "VID" / "val.txt").write_text("\n".join(lines))
    return str(root)


@pytest.fixture(scope="module")
def vid_root(tmp_path_factory):
    """tests/test_torch_vid.py's tree without gaps (every frame holds a box:
    the JAX package's train route raises on a frame without one)."""
    return write_vid_tree(str(tmp_path_factory.mktemp("vidwin")), seed=7, gaps=False)


def _vid(cls, root, **kw):
    return cls(root=os.path.join(root, "ImageNetVID", "ILSVRC"), **kw)


def test_window_sampler_clamping(clips):
    """The cases of tests/test_vid.py:68-84 on the port, and its windows
    equal JAX's."""
    ours = ImageNetVidDetection(root=clips, splits=[(2017, "val")], window=[5, 1])
    assert ours._windows[1] == [1, 1, 1, 2, 3]
    assert ours._windows[4] == [2, 3, 4, 5, 6]
    assert ours._windows[8] == [6, 7, 8, 8, 8]
    img, label = ours[0]
    assert img.shape == (5, 120, 160, 3) and img.dtype == np.uint8 and label.shape == (1, 5)
    strided = ImageNetVidDetection(root=clips, splits=[(2017, "val")], window=[3, 2])
    assert strided._windows[5] == [3, 5, 7] and strided._windows[1] == [1, 1, 3]
    assert strided.window == (3, 2)
    for ds, w in ((ours, [5, 1]), (strided, [3, 2])):
        assert ds._windows == JaxVID(root=clips, splits=[(2017, "val")], window=w)._windows


WINDOWS = [
    ("val_5_1", dict(splits=[(2017, "val")], window=[5, 1])),
    ("val_3_2", dict(splits=[(2017, "val")], window=[3, 2])),
    ("val_4_1", dict(splits=[(2017, "val")], window=[4, 1])),
    ("val_every3_3_1", dict(splits=[(2017, "val")], window=[3, 1], every=3)),
    ("train_3_1_noempty", dict(splits=[(2017, "train")], window=[3, 1], allow_empty=False)),
]


@pytest.mark.parametrize("name,kw", WINDOWS, ids=[w[0] for w in WINDOWS])
def test_windows_and_paths_match_jax(tmp_path_factory, name, kw):
    """On a tree with gaps (frames without boxes or without an XML): the
    samples, each window's frame ids and `window_paths`, and each key
    frame's label equal JAX's; windows keep every frame."""
    root = write_vid_tree(str(tmp_path_factory.mktemp(name)), seed=3)
    ours, ref = _vid(ImageNetVidDetection, root, **kw), _vid(JaxVID, root, **kw)
    assert ours.sample_ids == ref.sample_ids and ours._windows == ref._windows
    if "every" not in kw:
        assert len(ours) == len(ours.all_samples)
    for i in range(len(ours)):
        paths = ours.window_paths(i)
        assert paths == ref.window_paths(i) and len(paths) == kw["window"][0]
        assert ours.sample_path(i) == ref.sample_path(i) == paths[kw["window"][0] // 2]
        assert np.array_equal(ours.label_and_size(i)[0], ref._load_label(i)[:, :-1])


def test_window_sample_matches_jax(vid_root):
    """A window sample (no transform): the k frames stacked, as cv2 decodes
    them, and the key frame's label."""
    kw = dict(splits=[(2017, "val")], window=[3, 1], inference=True)
    ours, ref = _vid(ImageNetVidDetection, vid_root, **kw), _vid(JaxVID, vid_root, **kw)
    for i in (0, 5, len(ours) - 1):
        (a, la, ia), (b, lb, ib) = ours[i], ref[i]
        assert a.shape == (3, 96, 128, 3) and np.array_equal(a, b) and np.array_equal(la, lb) and ia == ib == i


def test_video_train_transform_matches_jax(vid_root):
    """One plan for the k frames, drawn in the JAX video transform's order
    from generators seeded as its globals: boxes, colour maps and flips
    bit-equal over 12 draws, the uint8 windows within the epoch tolerance
    of cv2's; every frame of a window cut with the same plan."""
    ds = _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], window=[3, 1])
    np.random.seed(4)
    random.seed(4)
    ref = JaxVideoTrain(3, 96, 64, device_color=True)
    ours = YOLO3VideoTrainTransform(3, 96, 64, np.random.RandomState(4), random.Random(4))
    diffs = []
    for i in range(12):
        img, label = ds[i]
        a, b = ours(img, label), ref(img, label)
        assert a[0].shape == b[0].shape == (3, 64, 96, 3) and a[0].dtype == b[0].dtype == np.uint8
        assert np.array_equal(a[1], b[1]) and a[1].dtype == b[1].dtype == np.float32 and np.array_equal(a[2], b[2])
        diffs.append(np.abs(a[0].astype(np.int32) - b[0].astype(np.int32)).mean())
    assert np.mean(diffs) < EPOCH_TOL, diffs
    # a static window gives k equal frames: one plan for all
    still = ours(np.repeat(img[:1], 3, axis=0), label)[0]
    assert np.array_equal(still[0], still[1]) and np.array_equal(still[0], still[2])
    host = YOLO3VideoTrainTransform(3, 96, 64, np.random.RandomState(5), random.Random(5), device_color=False)
    dev = YOLO3VideoTrainTransform(3, 96, 64, np.random.RandomState(5), random.Random(5))
    h, d = host(img, label), dev(img, label)
    assert h[0].dtype == np.float32 and np.array_equal(h[1], d[1])
    assert np.array_equal(h[0], (d[0].reshape(-1, 3).astype(np.float32) @ d[2][:, :3].T + d[2][:, 3]).reshape(h[0].shape))


def test_video_inference_transform_matches_jax(vid_root):
    """Each frame resized with interp 9 (area: the frames shrink) and
    normalised: the labels bit-equal, the pixels within the inference
    tolerance of tests/test_torch_pixels.py (mean 0.02, max 0.6 after
    normalising) of cv2's, and each frame bit-equal to the core's
    inference batch of its file."""
    ds = _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], window=[3, 1])
    for i in (0, 7):
        img, label = ds[i]
        ours = YOLO3VideoInferenceTransform(64, 64)(img, label, idx=i)
        ref = JaxVideoInference(64, 64)(img, label, idx=i)
        assert ours[2] == ref[2] == i and np.array_equal(ours[1], ref[1]) and ours[0].shape == (3, 64, 64, 3)
        d = np.abs(ours[0] - ref[0])
        assert ours[0].dtype == np.float32 and d.mean() < 0.02 and d.max() < 0.6, (d.mean(), d.max())
        assert np.array_equal(ours[0], native.load_batch(ds.window_paths(i), 64, 64)[0])


def _jax_epoch(root, seed):
    np.random.seed(seed)
    random.seed(seed)
    ds = _vid(JaxVID, root, splits=[(2017, "train")], window=[3, 1])
    loader = JaxLoader(ds, batch_size=3, shuffle=True, last_batch="discard", num_workers=1, seed=seed, max_boxes=8,
                       shape_sizes=[64, 96], shape_interval=1,
                       transform_factory=lambda w, h: JaxVideoTrain(3, w, h, device_color=True))
    return list(loader)


def _port_epoch(root, seed, workers):
    rs, rnd = np.random.RandomState(seed), random.Random(seed)
    ds = _vid(ImageNetVidDetection, root, splits=[(2017, "train")], window=[3, 1])
    loader = DetectionLoader(ds, batch_size=3, shuffle=True, last_batch="discard", num_workers=workers, seed=seed,
                             max_boxes=8, shape_sizes=[64, 96], shape_interval=1,
                             transform_factory=lambda w, h: YOLO3VideoTrainTransform(3, w, h, rs, rnd))
    return list(loader)


def test_window_epoch_matches_jax(vid_root):
    """A shuffled epoch of train windows over two shape buckets against
    JAX's per-sample route at num_workers=1: (B, 3, S, S, 3) uint8 batches,
    the keys, boxes, ids, labels and colour maps (one a window) bit-equal,
    the pixels within the epoch tolerance of cv2's; the same epoch at 4
    workers equals the port's at 1 bit for bit, and the prefetcher hands
    the 5-D batches over as they are."""
    ref = _jax_epoch(vid_root, 6)
    ours = _port_epoch(vid_root, 6, workers=1)
    assert len(ours) == len(ref) == 6 and {b["image"].shape[2] for b in ours} == {64, 96}
    diffs = []
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == {"image", "gt_boxes", "gt_ids", "label", "color"}
        assert a["image"].shape[:2] == (3, 3) and a["image"].dtype == b["image"].dtype == np.uint8
        assert a["color"].shape == (3, 3, 4)
        for k in b:
            if k != "image":
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        diffs.append(np.abs(a["image"].astype(np.float64) - b["image"]).mean())
    assert np.mean(diffs) < EPOCH_TOL, diffs
    four = _port_epoch(vid_root, 6, workers=4)
    for a, b in zip(ours, four):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    staged = list(device_prefetch(iter(ours), "cpu", keys=("image", "color")))
    assert all(torch.equal(s["image"], torch.from_numpy(a["image"])) for s, a in zip(staged, ours))


def test_window_inference_route(vid_root):
    """The loader's inference route for windows (the JAX detect CLI's
    Python transform): batches of (B, 3, S, S, 3) float32 with `idx` and the
    labels, each window equal to the video inference transform's."""
    ds = _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], window=[3, 1], inference=True)
    tf = YOLO3VideoInferenceTransform(64, 64)
    batches = list(DetectionLoader(ds, batch_size=4, num_workers=2, inference_transform=tf))
    assert sum(len(b["idx"]) for b in batches) == len(ds) and batches[0]["image"].shape == (4, 3, 64, 64, 3)
    b = batches[1]
    for n, i in enumerate(b["idx"]):
        img, label, _ = ds[int(i)]
        want, box, _ = tf(img, label, int(i))
        assert np.array_equal(b["image"][n], want) and np.array_equal(b["label"][n, : len(box), :4], box[:, :4])


def test_mixup_on_windows_raises_as_jax(vid_root):
    """JAX's MixupDetection cannot blend a window ((k, H, W, 3) samples
    into an (H, W, 3) canvas) and raises ValueError; the port raises a
    ValueError that says so, from the dataset wrapper and the loader."""
    ds = _vid(JaxVID, vid_root, splits=[(2017, "train")], window=[3, 1])
    with pytest.raises(ValueError):
        JaxMixup(ds)[0]
    ours = _vid(ImageNetVidDetection, vid_root, splits=[(2017, "train")], window=[3, 1])
    rs, rnd = np.random.RandomState(0), random.Random(0)
    with pytest.raises(ValueError, match="mixup blends single images"):
        MixupDetection(ours, rs)[0]
    loader = DetectionLoader(MixupDetection(ours, rs), batch_size=2, num_workers=1, shape_sizes=[64],
                             transform_factory=lambda w, h: YOLO3VideoTrainTransform(3, w, h, rs, rnd))
    with pytest.raises(ValueError, match="mixup blends single images"):
        next(iter(loader))
