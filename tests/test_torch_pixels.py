"""The port's per-sample pixel path against the JAX package's cv2 route on
the CPU: imresize and crop_resize_pad through the JPEG core's resampler,
the colour map on the host, the train and inference transforms' pixels,
MixupDetection, and whole loader epochs of the per-sample route (COCO,
mixup, host colour); then the train twin's flags this route brings.

The resampler follows cv2 for nearest, linear and cubic, takes an exact
fractional box for area and cubic for LANCZOS4, so against cv2 the pixels
are held to tests/test_native_train.py's per-filter tolerances; against
the core's own file route (native.load_train_batch) bit for bit."""
import os
import random
import sys

import cv2
import numpy as np
import pytest
import torch

from test_torch_coco import write_coco_tree
from test_torch_data import write_voc_tree
from videoyolo_tpu.data.loader import DetectionLoader as JaxLoader
from videoyolo_tpu.data.mscoco import COCODetection as JaxCOCO
from videoyolo_tpu.data.transforms import MixupDetection as JaxMixup
from videoyolo_tpu.data.transforms import YOLO3DefaultInferenceTransform as JaxInferenceTransform
from videoyolo_tpu.data.transforms import YOLO3DefaultTrainTransform as JaxTrainTransform
from videoyolo_tpu.data.transforms import apply_color_np as jax_apply_color
from videoyolo_tpu.data.transforms import crop_resize_pad as jax_crop_resize_pad
from videoyolo_tpu.data.transforms import imresize as jax_imresize
from videoyolo_torch import native, train_yolov3
from videoyolo_torch.data.loader import DetectionLoader
from videoyolo_torch.data.mscoco import COCODetection
from videoyolo_torch.data.pascalvoc import VOCDetection
from videoyolo_torch.models.factory import yolo3_darknet53
from videoyolo_torch.data.transforms import (
    MixupDetection,
    YOLO3DefaultInferenceTransform,
    YOLO3DefaultTrainTransform,
    apply_color_np,
    crop_resize_pad,
    imresize,
)
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

# tests/test_native_train.py:40-47: (cv2 filter the core is held to, mean
# abs tolerance) per interp; area is checked on shrinking windows only
TOLS = {0: (0, 0.01), 1: (1, 0.5), 2: (2, 0.5), 3: (3, 8.0), 4: (2, 0.5)}
EPOCH_TOL = 6.0  # tests/test_native_train.py:119, a whole epoch's mean abs
# the same in normalised floats after a colour map: its gain is at most
# about 1.5 (contrast) x 1.5 (saturation) / (255 x 0.224) a channel, summed
# over three channels by the hue rotation
HOST_TOL = EPOCH_TOL * 1.5 * 1.5 * 3 / (255 * 0.224)


@pytest.fixture(scope="module")
def jpeg(tmp_path_factory):
    """A 360x480 noise JPEG (the file of tests/test_native_train.py) and its
    pixels as cv2 decodes them (the core decodes the same)."""
    p = str(tmp_path_factory.mktemp("pix") / "a.jpg")
    cv2.imwrite(p, np.random.RandomState(0).randint(0, 255, (360, 480, 3), np.uint8))
    img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
    assert np.array_equal(native.decode(p), img)
    return p, img


@pytest.mark.parametrize("interp,out_hw", [(0, (96, 144)), (1, (96, 144)), (2, (500, 600)), (3, (96, 144)),
                                           (4, (400, 520)), (9, (96, 144)), (9, (500, 600))])
def test_imresize_matches_cv2(jpeg, interp, out_hw):
    """imresize against JAX's cv2 imresize: 9 is area when shrinking, cubic
    when growing; 4 is held to cv2's cubic."""
    _, img = jpeg
    h, w = out_hw
    eff = (3 if h < img.shape[0] else 2) if interp == 9 else interp
    ours = imresize(img, w, h, interp)
    ref = jax_imresize(img, w, h, TOLS[eff][0])
    assert ours.shape == ref.shape == (h, w, 3) and ours.dtype == np.uint8
    d = np.abs(ours.astype(np.int32) - ref.astype(np.int32)).mean()
    assert d <= TOLS[eff][1], (interp, d)


def test_imresize_random_filter_draws_from_rnd(jpeg):
    """Code 10 draws the filter from the generator passed, as JAX's from the
    global `random`; without one it raises."""
    _, img = jpeg
    for seed in range(4):
        want = random.Random(seed).randint(0, 4)
        assert np.array_equal(imresize(img, 64, 48, 10, rnd=random.Random(seed)), imresize(img, 64, 48, want))
    with pytest.raises(ValueError, match="rnd"):
        imresize(img, 64, 48, 10)


def _trials(n=15, seed=1):
    rs = np.random.RandomState(seed)
    for trial in range(n):
        interp = trial % 5
        x0, y0 = int(rs.randint(-150, 400)), int(rs.randint(-150, 300))
        if interp == 3:  # area: both sides on the shrinking path
            cw, ch = int(rs.randint(520, 800)), int(rs.randint(520, 800))
        else:
            cw, ch = int(rs.randint(60, 800)), int(rs.randint(60, 800))
        yield interp, (x0, y0, cw, ch), bool(rs.randint(0, 2))


def test_crop_resize_pad_matches_cv2(jpeg):
    """tests/test_native_train.py's 15 windows, inside and beyond the image,
    against JAX's cv2 crop_resize_pad within the per-filter tolerances."""
    _, img = jpeg
    for interp, rect, _ in _trials():
        ours = crop_resize_pad(img, rect, 256, 256, interp, [124, 117, 104])
        ref = jax_crop_resize_pad(img, rect, 256, 256, TOLS[interp][0], [124, 117, 104])
        d = np.abs(ours.astype(np.int32) - ref.astype(np.int32)).mean()
        assert d <= TOLS[interp][1], (interp, rect, d)


def test_crop_resize_pad_equals_the_file_route(jpeg, tmp_path):
    """On decoded pixels, bit-equal to native.load_train_batch on the file for
    the same plan: every filter, flips, windows inside and beyond the image,
    a non-integral fill (rounded alike), and a (96, 80) tile."""
    path, img = jpeg
    trials = list(_trials(20, seed=2))
    fill = [123.675, 116.28, 103.53]
    for out_h, out_w in ((256, 256), (96, 80)):
        want = native.load_train_batch([path] * len(trials), np.array([t[1] for t in trials]),
                                       np.array([t[2] for t in trials]), np.array([t[0] for t in trials]),
                                       out_h, out_w, fill)
        for i, (interp, rect, flip) in enumerate(trials):
            got = native.crop_resize_pad(img, rect, out_h, out_w, interp, fill, flip)
            assert np.array_equal(got, want[i]), (interp, rect, flip)
    with pytest.raises(ValueError, match="uint8"):
        native.crop_resize_pad(img.astype(np.float32), (0, 0, 10, 10), 8, 8, 1, fill)
    with pytest.raises(ValueError, match="interp"):
        native.crop_resize_pad(img, (0, 0, 10, 10), 8, 8, 9, fill)


def test_apply_color_np_bit_equal():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (2, 40, 50, 3)).astype(np.uint8)
    mat = rs.randn(3, 4).astype(np.float32)
    for x in (img, img[0]):
        ours, ref = apply_color_np(x, mat), jax_apply_color(x, mat)
        assert ours.dtype == ref.dtype == np.float32 and np.array_equal(ours, ref)


@pytest.mark.parametrize("device_color", [True, False])
def test_train_transform_call_matches_jax(jpeg, device_color):
    """`__call__` on decoded pixels, over 12 draws: the boxes and colour maps
    bit-equal to JAX's (the same generators), the uint8 tiles within the
    epoch tolerance of cv2's; with the colour map on the host, the float32
    pixels are the map applied to the port's own tile, bit for bit."""
    _, img = jpeg
    label = np.array([[40.0, 50.0, 200.0, 210.0, 1.0], [300.0, 20.0, 470.0, 350.0, 4.0]])
    np.random.seed(9)
    random.seed(9)
    ref = JaxTrainTransform(128, 96, device_color=device_color)
    ours = YOLO3DefaultTrainTransform(128, 96, np.random.RandomState(9), random.Random(9),
                                      device_color=device_color)
    twin = YOLO3DefaultTrainTransform(128, 96, np.random.RandomState(9), random.Random(9), device_color=True)
    diffs = []
    for _ in range(12):
        b = ref(img, label)
        a = ours(img, label)
        t = twin(img, label)
        assert np.array_equal(a[1], b[1]) and a[1].dtype == b[1].dtype == np.float32
        if device_color:
            assert len(a) == len(b) == 3 and np.array_equal(a[2], b[2]) and a[0].dtype == np.uint8
            diffs.append(np.abs(a[0].astype(np.int32) - b[0].astype(np.int32)).mean())
        else:
            assert len(a) == len(b) == 2 and a[0].dtype == b[0].dtype == np.float32
            assert np.array_equal(a[0], apply_color_np(t[0], t[2]))
            diffs.append(np.abs(a[0] - b[0]).mean())
    assert np.mean(diffs) < (EPOCH_TOL if device_color else HOST_TOL), diffs


def test_inference_transform_call_matches_jax(jpeg):
    """Resize (interp 9) and normalise: the labels bit-equal, the pixels
    within tests/test_native.py's inference tolerance (mean 0.02, max 0.6
    after normalising) of cv2's, and bit-equal to the core's inference
    batch of the file."""
    path, img = jpeg
    label = np.array([[40.0, 50.0, 200.0, 210.0, 1.0]])
    for hw in ((96, 128), (416, 520)):
        ours = YOLO3DefaultInferenceTransform(hw[1], hw[0])(img, label, idx=3)
        ref = JaxInferenceTransform(hw[1], hw[0])(img, label, idx=3)
        assert ours[2] == ref[2] == 3 and np.array_equal(ours[1], ref[1])
        d = np.abs(ours[0] - ref[0])
        assert ours[0].dtype == np.float32 and d.mean() < 0.02 and d.max() < 0.6, (hw, d.mean(), d.max())
        assert np.array_equal(ours[0], native.load_batch([path], *hw)[0][0])


class _Pairs:
    """An in-memory dataset of (uint8 image, label) for both packages'
    MixupDetection."""

    def __init__(self, imgs, labels):
        self.imgs, self.labels = imgs, labels

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i].copy(), self.labels[i].copy()


def test_mixup_matches_jax():
    """Given the same pixels and seeds, the blended uint8 images and labels
    (both images' boxes, their ratios as the last column) bit-equal to
    JAX's, images of unequal sizes among them; with mixup off, the image
    itself and a ratio of 1."""
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, (int(rs.randint(40, 90)), int(rs.randint(40, 90)), 3)).astype(np.uint8)
            for _ in range(6)]
    labels = [np.concatenate([rs.uniform(0, 40, (k, 4)), rs.randint(0, 5, (k, 1))], 1) for k in (1, 2, 3, 1, 2, 4)]
    labels[3] = np.array([[-1, -1, -1, -1, -1]])  # an image without boxes (int rows)
    ours, ref = MixupDetection(_Pairs(imgs, labels), np.random.RandomState(4)), JaxMixup(_Pairs(imgs, labels))
    np.random.seed(4)
    mixed = 0
    for enabled in (True, False):
        ours.set_mixup(enabled)
        ref.set_mixup(enabled)
        for i in list(range(6)) * 3:
            (a_img, a_lab), (b_img, b_lab) = ours[i], ref[i]
            assert a_img.dtype == b_img.dtype == np.uint8 and np.array_equal(a_img, b_img)
            assert a_lab.dtype == b_lab.dtype and np.array_equal(a_lab, b_lab)
            mixed += len(a_lab) > len(labels[i])
            if not enabled:
                assert np.array_equal(a_img, imgs[i]) and (a_lab[:, -1] == 1).all()
    assert mixed > 6 and len(ours) == 6 and ours.imgs is imgs  # attributes pass to the wrapped set


# --------------------------------------------------------------------------
# loader epochs of the per-sample route
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco_tree(str(tmp_path_factory.mktemp("coco_px")), seed=2, splits={"train2017": 12})


TRAIN = dict(splits=["instances_train2017"])


def _jax_epoch(root, seed, mixup, device_color):
    np.random.seed(seed)
    random.seed(seed)
    ds = JaxCOCO(root=os.path.join(root, "MSCoco"), **TRAIN)
    loader = JaxLoader(
        JaxMixup(ds) if mixup else ds, batch_size=3, shuffle=True, last_batch="discard", num_workers=1, seed=seed,
        max_boxes=8, mixup=mixup, shape_sizes=[64, 96], shape_interval=1,
        transform_factory=lambda w, h: JaxTrainTransform(w, h, mixup=mixup, device_color=device_color),
    )
    return list(loader)


def _port_epoch(root, seed, mixup, device_color, workers, dataset_cls=COCODetection, **kw):
    rs, rnd = np.random.RandomState(seed), random.Random(seed)
    ds = dataset_cls(root=os.path.join(root, "MSCoco") if dataset_cls is COCODetection else root, **kw)
    loader = DetectionLoader(
        MixupDetection(ds, rs) if mixup else ds, batch_size=3, shuffle=True, last_batch="discard",
        num_workers=workers, seed=seed, max_boxes=8, shape_sizes=[64, 96], shape_interval=1,
        transform_factory=lambda w, h: YOLO3DefaultTrainTransform(w, h, rs, rnd, device_color=device_color),
    )
    return list(loader)


@pytest.mark.parametrize("mixup,device_color", [(True, True), (False, False)])
def test_per_sample_epoch_matches_jax(coco_root, mixup, device_color):
    """A shuffled COCO epoch over two shape buckets against JAX's per-sample
    route at num_workers=1: the keys, gt boxes, ids, labels, gt_mix (under
    mixup) and colour maps bit-equal, the pixels within the epoch
    tolerance (uint8, or the normalised floats of --host_color); the same
    epoch at 4 workers equals the port's at 1 bit for bit."""
    ref = _jax_epoch(coco_root, 6, mixup, device_color)
    ours = _port_epoch(coco_root, 6, mixup, device_color, workers=1, **TRAIN)
    assert len(ours) == len(ref) == 4 and {b["image"].shape[1] for b in ours} == {64, 96}
    diffs = []
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        assert ("gt_mix" in a) == mixup and ("color" in a) == device_color
        for k in b:
            if k != "image":
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert a["image"].dtype == b["image"].dtype == (np.uint8 if device_color else np.float32)
        diffs.append(np.abs(a["image"].astype(np.float64) - b["image"]).mean())
    assert np.mean(diffs) < (EPOCH_TOL if device_color else HOST_TOL), diffs
    if mixup:
        mixes = np.concatenate([b["gt_mix"][b["gt_ids"] >= 0] for b in ours])
        assert ((mixes > 0) & (mixes <= 1)).all() and np.unique(np.round(mixes, 3)).size > 2
    four = _port_epoch(coco_root, 6, mixup, device_color, workers=4, **TRAIN)
    for a, b in zip(ours, four):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_host_colour_is_the_device_map_applied(coco_root):
    """The same seeds with the colour map on the host give the device
    route's uint8 tiles with their maps applied, bit for bit."""
    dev = _port_epoch(coco_root, 3, True, True, workers=2, **TRAIN)
    host = _port_epoch(coco_root, 3, True, False, workers=2, **TRAIN)
    for a, b in zip(dev, host):
        assert np.array_equal(a["label"], b["label"]) and np.array_equal(a["gt_mix"], b["gt_mix"])
        for i in range(len(a["image"])):
            assert np.array_equal(b["image"][i], apply_color_np(a["image"][i], a["color"][i]))


class _NoNative(VOCDetection):
    native_train_ok = False


def test_per_sample_tile_equals_the_native_route(tmp_path):
    """On VOC, whose XML sizes are the JPEGs', the per-sample route (taken
    here by a dataset without native_train_ok) gives the native train
    batch's epoch bit for bit: the same plans, and tiles cut from decoded
    pixels equal to the file route's."""
    root = os.path.join(write_voc_tree(str(tmp_path)), "PascalVOC", "VOCdevkit")
    kw = dict(splits=[(2007, "trainval"), (2012, "trainval")])
    native_epoch = _port_epoch(root, 5, False, True, workers=2, dataset_cls=VOCDetection, **kw)
    sample_epoch = _port_epoch(root, 5, False, True, workers=2, dataset_cls=_NoNative, **kw)
    assert len(native_epoch) == len(sample_epoch) == 4
    for a, b in zip(native_epoch, sample_epoch):
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------
# the train twin's flags
# --------------------------------------------------------------------------

def test_train_twin_flags(monkeypatch):
    """--syncbn, --gpus and --num_samples are accepted in one process and
    with WORLD_SIZE=2 (the data-parallel twin: tests/test_torch_ddp.py); the
    datasets (the combined ones and YouTube-BB windows among them), --mixup
    and --host_color pass; windows on no single video dataset and
    --mult_out beyond vid raise; the paths still to port raise, naming
    their items."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for argv in (["--syncbn"], ["--dataset", "coco", "--mixup", "--host_color"], ["--dataset", "det"],
                 ["--dataset", "vid", "--every", "5", "--noallow_empty"], ["--dataset", "coco", "--dataset_val", "voc"],
                 ["--dataset", "vid", "--window", "3,1", "--k_join_pos", "late", "--corr_pos", "early"],
                 ["--dataset", "vid", "--window", "5,1", "--temp", "--mult_out"], ["--dataset", "comb"],
                 ["--dataset", "voc,coco,det,vid,yt"], ["--dataset", "yt", "--window", "3,1"]):
        train_yolov3.check_ported(train_yolov3.parse_args(argv))
    for argv in (["--window", "3,1"], ["--dataset", "vid,voc", "--window", "3,1"]):  # train_yolov3.py:775-776
        with pytest.raises(ValueError, match="video dataset"):
            train_yolov3.check_ported(train_yolov3.parse_args(argv))
    for argv in (["--dataset", "yt", "--window", "5,1", "--mult_out"], ["--dataset", "comb", "--mult_out"]):
        with pytest.raises(ValueError, match="only the vid dataset"):
            train_yolov3.check_ported(train_yolov3.parse_args(argv))
    monkeypatch.setenv("WORLD_SIZE", "1")
    train_yolov3.check_ported(train_yolov3.parse_args(["--syncbn"]))
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = train_yolov3.parse_args(["--syncbn", "--gpus", "0,1,2,3", "--num_samples", "100"])
    train_yolov3.check_ported(args)
    assert args.syncbn and args.gpus == ["0", "1", "2", "3"] and args.num_samples == 100
    monkeypatch.delenv("WORLD_SIZE")
    for argv, item in ((["--features_dir", "f"], "item 13"), (["--trained_on", "voc"], "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            train_yolov3.check_ported(train_yolov3.parse_args(argv))
    # the 3-D blocks and the conv-RNN train (tests/test_torch_blocks3d.py,
    # tests/test_torch_rnn.py); the model refuses what the JAX package
    # asserts on or runs at fault
    for argv in (["--block_conv_type", "21", "--k_join_pos", "late"], ["--rnn_pos", "late", "--k_join_pos", "late"]):
        args = train_yolov3.parse_args(["--dataset", "vid", "--window", "3,1"] + argv)
        train_yolov3.check_ported(args)
        with torch.device("meta"):
            yolo3_darknet53(2, **train_yolov3.temporal_kwargs(args))
    for argv, match in ((["--block_conv_type", "21"], "join late"),
                        (["--rnn_pos", "late", "--k_join_pos", "late", "--corr_pos", "early", "--corr_d", "2"],
                         "not built")):
        with pytest.raises(ValueError, match=match):
            yolo3_darknet53(2, **train_yolov3.temporal_kwargs(train_yolov3.parse_args(
                ["--dataset", "vid", "--window", "3,1"] + argv)))
    args = train_yolov3.parse_args([])
    assert args.allow_empty and args.no_mixup_epochs == 20 and args.every == 25 and not args.syncbn
    assert sys.modules["videoyolo_torch.train_yolov3"] is train_yolov3
