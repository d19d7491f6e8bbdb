"""Input transforms (port of videoyolo_tpu/data/transforms.py).

On the device: `to_normalized`.  On the host:

  * the `bbox_*` helpers and `random_crop_with_constraints`, on a single
    (N, 4+) array or a list of them;
  * `_sample_train_geometry` (expand, constrained crop, flip) and
    `sample_color_matrix` (the photometric distortion and the
    normalisation as one (3, 4) affine map);
  * `YOLO3DefaultTrainTransform`: `plan` samples the whole augmentation
    from the label and the image size, which the JPEG core carries out on
    the file (native.load_train_batch); `__call__` carries it out on
    decoded pixels, with the colour map returned for the device or applied
    here (`device_color=False`, the train twin's --host_color);
  * `YOLO3DefaultInferenceTransform`: resize (interp 9) and normalise;
  * `YOLO3VideoTrainTransform` and `YOLO3VideoInferenceTransform`: the same
    on (k, H, W, 3) windows, one plan (one set of draws) for all k frames;
  * the pixel helpers `imresize`, `crop_resize_pad` and `apply_color_np`,
    and `MixupDetection`, which blends pairs of images and their labels.

The JAX package resizes with cv2; the port with the JPEG core's resampler
(native.crop_resize_pad), which follows cv2 for nearest, linear and cubic,
takes an exact fractional box for area and cubic for LANCZOS4 (interp 4):
the pixels agree with cv2's within the tolerances of
tests/test_native_train.py, not bit for bit.  The fill of a crop outside
the image is rounded (124, 116, 104 for the ImageNet mean), as the core's
file route rounds it; cv2's route truncates it (123, 116, 103).

The JAX transforms draw from the global `np.random` and `random`.  These
take the generators explicitly, an `np.random.RandomState` (`rs`) and a
`random.Random` (`rnd`), and draw from them in the same order, so
generators seeded as the JAX package's globals give its plans exactly.
"""
from __future__ import annotations

import random
from typing import List, Optional, Union

import numpy as np
import torch

from .. import native
from ..ops.bbox import np_bbox_iou

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

Boxes = Union[np.ndarray, List[np.ndarray]]


def to_normalized(img: torch.Tensor, mean=MEAN, std=STD, dtype=torch.float32) -> torch.Tensor:
    """[0, 255] (..., H, W, 3) -> (x/255 - mean)/std computed in float32,
    then cast to `dtype`.  Channel-last, as in the JAX package.

    `mean` / `std` may be tensors already on `img`'s device, which saves a
    host-to-device copy per call."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=img.device)
    return ((img.float() / 255.0 - mean) / std).to(dtype)


def normalized_np(img: np.ndarray, mean=MEAN, std=STD) -> np.ndarray:
    """[0, 255] HWC -> (x/255 - mean)/std in float32 on the host (the JAX
    package's numpy `to_normalized`)."""
    img = img.astype(np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


# --------------------------------------------------------------------------
# pixels (videoyolo_tpu/data/transforms.py:43-53, 377-425)
# --------------------------------------------------------------------------

def imresize(img: np.ndarray, width: int, height: int, interp: int = 1,
             rnd: Optional[random.Random] = None) -> np.ndarray:
    """Resize HWC uint8 RGB pixels to (height, width) with mxnet's interp
    codes: 0 nearest, 1 linear, 2 cubic, 3 area, 4 LANCZOS4 (cubic here), 9
    area when shrinking and cubic otherwise, 10 a random one of 0-4 drawn
    from `rnd` (JAX: the global `random`)."""
    if interp == 9:
        interp = 3 if (img.shape[0] > height or img.shape[1] > width) else 2
    if interp == 10:
        if rnd is None:
            raise ValueError("interp 10 draws the filter: pass rnd")
        interp = rnd.randint(0, 4)
    h, w = img.shape[:2]
    return native.crop_resize_pad(img, (0, 0, w, h), height, width, interp, (0, 0, 0))


def crop_resize_pad(img: np.ndarray, rect, out_w: int, out_h: int, interp: int, fill) -> np.ndarray:
    """Resize the crop window `rect` = (x0, y0, w, h) of `img` (image
    coordinates; it may reach beyond the image, which is how the random
    expand composes with the crop) to (out_h, out_w); the part of the
    window outside the image is `fill`."""
    return native.crop_resize_pad(img, rect, out_h, out_w, interp, fill)


def apply_color_np(img: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a (3, 4) colour map to HWC / KHWC [0, 255] pixels on the host."""
    flat = img.reshape(-1, 3).astype(np.float32)
    out = flat @ mat[:, :3].T + mat[:, 3]
    return out.reshape(img.shape).astype(np.float32)


# --------------------------------------------------------------------------
# bbox transforms (a single array or a list per timestep)
# --------------------------------------------------------------------------

def _listify(bboxs: Boxes):
    if isinstance(bboxs, list):
        return bboxs, False
    return [bboxs], True


def bbox_crop(bboxs: Boxes, crop_box=None, allow_outside_center: bool = True) -> Boxes:
    """Crop boxes to a (x, y, w, h) region."""
    boxes_list, single = _listify(bboxs)
    out = []
    for bbox in boxes_list:
        bbox = bbox.copy()
        if crop_box is None or all(c is None for c in crop_box):
            out.append(bbox)
            continue
        l, t, w, h = crop_box
        left = l or 0
        top = t or 0
        right = left + (w if w else np.inf)
        bottom = top + (h if h else np.inf)
        crop_bbox = np.array((left, top, right, bottom))
        if allow_outside_center:
            mask = np.ones(bbox.shape[0], dtype=bool)
        else:
            centers = (bbox[:, :2] + bbox[:, 2:4]) / 2
            mask = np.logical_and(crop_bbox[:2] <= centers, centers < crop_bbox[2:]).all(axis=1)
        bbox[:, :2] = np.maximum(bbox[:, :2], crop_bbox[:2])
        bbox[:, 2:4] = np.minimum(bbox[:, 2:4], crop_bbox[2:4])
        bbox[:, :2] -= crop_bbox[:2]
        bbox[:, 2:4] -= crop_bbox[:2]
        mask = np.logical_and(mask, (bbox[:, :2] < bbox[:, 2:4]).all(axis=1))
        out.append(bbox[mask])
    return out[0] if single else out


def bbox_flip(bboxs: Boxes, size, flip_x: bool = False, flip_y: bool = False) -> Boxes:
    width, height = size
    boxes_list, single = _listify(bboxs)
    out = []
    for bbox in boxes_list:
        bbox = bbox.copy()
        if flip_y:
            ymax = height - bbox[:, 1]
            ymin = height - bbox[:, 3]
            bbox[:, 1], bbox[:, 3] = ymin, ymax
        if flip_x:
            xmax = width - bbox[:, 0]
            xmin = width - bbox[:, 2]
            bbox[:, 0], bbox[:, 2] = xmin, xmax
        out.append(bbox)
    return out[0] if single else out


def bbox_resize(bboxs: Boxes, in_size, out_size) -> Boxes:
    """Scale boxes from `in_size` to `out_size` (w, h).  An integer label,
    such as allow_empty's lone [-1] * 5 row, is scaled in float64; the JAX
    package raises on it (ROADMAP.md Queue 3)."""
    boxes_list, single = _listify(bboxs)
    x_scale = out_size[0] / in_size[0]
    y_scale = out_size[1] / in_size[1]
    out = []
    for bbox in boxes_list:
        bbox = bbox.copy() if np.issubdtype(bbox.dtype, np.floating) else bbox.astype(np.float64)
        bbox[:, 0] *= x_scale
        bbox[:, 2] *= x_scale
        bbox[:, 1] *= y_scale
        bbox[:, 3] *= y_scale
        out.append(bbox)
    return out[0] if single else out


def bbox_translate(bboxs: Boxes, x_offset=0, y_offset=0) -> Boxes:
    boxes_list, single = _listify(bboxs)
    out = []
    for bbox in boxes_list:
        bbox = bbox.copy()
        bbox[:, :2] += (x_offset, y_offset)
        bbox[:, 2:4] += (x_offset, y_offset)
        out.append(bbox)
    return out[0] if single else out


def random_crop_with_constraints(
    bboxs: Boxes,
    size,
    rs: np.random.RandomState,
    min_scale: float = 0.3,
    max_scale: float = 1.0,
    max_aspect_ratio: float = 2.0,
    constraints=None,
    max_trial: int = 50,
):
    """SSD-style min-IoU constrained random crop: each constraint's
    `max_trial` crops are drawn as one batch and the first that satisfies
    it, in draw order, is a candidate; one candidate is then drawn."""
    if constraints is None:
        constraints = ((0.1, None), (0.3, None), (0.5, None), (0.7, None), (0.9, None), (None, 1))
    w, h = size
    boxes_list, single = _listify(bboxs)
    all_boxes = np.concatenate(
        [b[:, :4] for b in boxes_list if len(b)], axis=0
    ) if any(len(b) for b in boxes_list) else np.zeros((0, 4))

    candidates = [(0, 0, w, h)]
    for min_iou, max_iou in constraints:
        min_iou = -np.inf if min_iou is None else min_iou
        max_iou = np.inf if max_iou is None else max_iou
        scale = rs.uniform(min_scale, max_scale, max_trial)
        aspect_ratio = rs.uniform(
            np.maximum(1 / max_aspect_ratio, scale * scale),
            np.minimum(max_aspect_ratio, 1 / (scale * scale)),
        )
        crop_h = (h * scale / np.sqrt(aspect_ratio)).astype(np.int64)
        crop_w = (w * scale * np.sqrt(aspect_ratio)).astype(np.int64)
        geom_ok = (crop_h < h) & (crop_w < w) & (crop_h > 0) & (crop_w > 0)
        span_h = np.maximum(h - crop_h, 1)
        span_w = np.maximum(w - crop_w, 1)
        crop_t = (rs.uniform(0, 1, max_trial) * span_h).astype(np.int64)
        crop_l = (rs.uniform(0, 1, max_trial) * span_w).astype(np.int64)

        if len(all_boxes) == 0:
            if geom_ok.any():
                i = int(np.argmax(geom_ok))
                out = boxes_list[0] if single else boxes_list
                return out, (int(crop_l[i]), int(crop_t[i]), int(crop_w[i]), int(crop_h[i]))
            continue

        crop_bb = np.stack(
            [crop_l, crop_t, crop_l + crop_w, crop_t + crop_h], axis=1
        ).astype(np.float64)
        iou = np_bbox_iou(all_boxes, crop_bb)  # (N, T)
        ok = geom_ok & (iou.min(axis=0) >= min_iou) & (iou.max(axis=0) <= max_iou)
        if ok.any():
            i = int(np.argmax(ok))
            candidates.append(
                (int(crop_l[i]), int(crop_t[i]), int(crop_w[i]), int(crop_h[i]))
            )

    while candidates:
        crop_b = candidates.pop(rs.randint(0, len(candidates)))
        new_bboxs = bbox_crop(
            boxes_list if not single else boxes_list[0], crop_b, allow_outside_center=False
        )
        check = [new_bboxs] if single else new_bboxs
        if any(nb.size < 1 for nb in check):
            continue
        return new_bboxs, tuple(crop_b)
    out = boxes_list[0] if single else boxes_list
    return out, (0, 0, w, h)


# --------------------------------------------------------------------------
# the colour map
# --------------------------------------------------------------------------

_YIQ = np.array(
    [[0.299, 0.587, 0.114], [0.596, -0.274, -0.321], [0.211, -0.523, 0.311]]
)
_YIQ_INV = np.array(
    [[1.0, 0.956, 0.621], [1.0, -0.272, -0.647], [1.0, -1.107, 1.705]]
)
_LUMA = np.array([0.299, 0.587, 0.114])


def sample_color_matrix(
    rs: np.random.RandomState,
    rnd: random.Random,
    brightness_delta: int = 32,
    contrast_low: float = 0.5,
    contrast_high: float = 1.5,
    saturation_low: float = 0.5,
    saturation_high: float = 1.5,
    hue_delta: int = 18,
    mean=MEAN,
    std=STD,
) -> np.ndarray:
    """The reference's photometric distortion composed with the input
    normalisation as one affine colour map: a (3, 4) float32 matrix M with
    out = M[:, :3] @ rgb + M[:, 3] on [0, 255] pixels.  Applied on the
    device after the crop, resize and flip (ops/color.py), which it
    commutes with."""
    A = np.eye(3)
    b = np.zeros(3)

    def compose(A2, b2):
        nonlocal A, b
        A = A2 @ A
        b = A2 @ b + b2

    def brightness():
        if rs.uniform() > 0.5:
            compose(np.eye(3), np.full(3, rs.uniform(-brightness_delta, brightness_delta)))

    def contrast():
        if rs.uniform() > 0.5:
            compose(np.eye(3) * rs.uniform(contrast_low, contrast_high), np.zeros(3))

    def saturation():
        if rs.uniform() > 0.5:
            alpha = rs.uniform(saturation_low, saturation_high)
            compose(alpha * np.eye(3) + (1.0 - alpha) * np.outer(np.ones(3), _LUMA), np.zeros(3))

    def hue():
        if rs.uniform() > 0.5:
            alpha = rnd.uniform(-hue_delta, hue_delta)
            u, w_ = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
            bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w_], [0.0, w_, u]])
            compose(_YIQ_INV @ bt @ _YIQ, np.zeros(3))

    brightness()
    if rs.randint(0, 2):
        contrast()
        saturation()
        hue()
    else:
        saturation()
        hue()
        contrast()
    # normalize: (x/255 - mean)/std
    compose(np.diag(1.0 / (255.0 * np.asarray(std))), -np.asarray(mean) / np.asarray(std))
    return np.concatenate([A, b[:, None]], axis=1).astype(np.float32)


# --------------------------------------------------------------------------
# YOLO3 pipelines
# --------------------------------------------------------------------------

def _float32(bbox: Boxes) -> Boxes:
    """A label, or a window's list of per-frame labels, as float32."""
    if isinstance(bbox, list):
        return [b.astype(np.float32) for b in bbox]
    return bbox.astype(np.float32)


def _sample_train_geometry(label, w, h, rs: np.random.RandomState, rnd: random.Random,
                           max_expand_ratio: float = 4.0):
    """Expand (p=.5) + constrained crop + flip, labels only.

    Returns (bbox, rect, flip): `rect` is the crop window in the original
    image's coordinates and may extend beyond the image (those parts are
    the expand fill)."""
    if rs.uniform() > 0.5:
        ratio = rnd.uniform(1, max_expand_ratio)
        ow, oh = int(w * ratio), int(h * ratio)
        off_x = rnd.randint(0, ow - w)
        off_y = rnd.randint(0, oh - h)
        bbox = bbox_translate(label, x_offset=off_x, y_offset=off_y)
    else:
        off_x = off_y = 0
        ow, oh = w, h
        bbox = [b.copy() for b in label] if isinstance(label, list) else label.copy()
    bbox, crop = random_crop_with_constraints(bbox, (ow, oh), rs)
    x0, y0, cw, ch = [int(c) for c in crop]
    rect = (x0 - off_x, y0 - off_y, cw, ch)
    return bbox, rect, rs.uniform() > 0.5


class YOLO3DefaultTrainTransform:
    """The train augmentation: random expand (p=.5), constrained crop,
    resize with a random filter, random flip, and the photometric
    distortion with the normalisation as one colour map.  `plan` samples it
    without the pixels; `__call__` (`apply` on a plan) carries it out on
    decoded pixels and returns (uint8 img, bbox, colour map) with
    `device_color` (the map applied on the device; the default here, where
    JAX's default is False) or (normalised float32 img, bbox)."""

    def __init__(self, width, height, rs: np.random.RandomState, rnd: random.Random,
                 mean=MEAN, std=STD, device_color: bool = True):
        self._width = width
        self._height = height
        self._rs = rs
        self._rnd = rnd
        self._mean = mean
        self._std = std
        self._device_color = device_color

    def plan(self, label, w, h):
        """The whole augmentation of a (w, h) image without its pixels:
        (bbox_out in output coordinates, rect, flip, interp, color_matrix)."""
        bbox, rect, flip = _sample_train_geometry(label, w, h, self._rs, self._rnd)
        interp = int(self._rs.randint(0, 5))
        bbox = bbox_resize(bbox, (rect[2], rect[3]), (self._width, self._height))
        if flip:
            bbox = bbox_flip(bbox, (self._width, self._height), flip_x=True)
        mat = sample_color_matrix(self._rs, self._rnd, mean=self._mean, std=self._std)
        return bbox, rect, flip, interp, mat

    @property
    def fill(self):
        return [m * 255 for m in self._mean]

    @property
    def out_wh(self):
        return self._width, self._height

    @property
    def device_color(self) -> bool:
        return self._device_color

    def __call__(self, src, label):
        h, w = src.shape[-3:-1]
        return self.apply(src, self.plan(label, w, h))

    def apply(self, src, plan):
        """A plan's pixels from decoded (h, w, 3) uint8 `src`; draws nothing,
        so worker threads may call it."""
        bbox, rect, flip, interp, mat = plan
        img = native.crop_resize_pad(src, rect, self._height, self._width, interp, self.fill, flip)
        if self._device_color:
            return img, _float32(bbox), mat
        return apply_color_np(img, mat), _float32(bbox)


class YOLO3DefaultInferenceTransform:
    """Resize (interp 9) + normalise.  The loaders take the pixels from the
    JPEG core's inference batch (native.load_batch, the same resampling)
    and the labels from `label`; `__call__` does both on decoded pixels."""

    def __init__(self, width, height, mean=MEAN, std=STD):
        self._width = width
        self._height = height
        self._mean = mean
        self._std = std

    @property
    def out_wh(self):
        return self._width, self._height

    def label(self, label, w, h):
        """A (w, h) image's label in the output's coordinates (a list of
        labels, one a frame, stays a list)."""
        return _float32(bbox_resize(label, (w, h), (self._width, self._height)))

    def __call__(self, src, label, idx=None):
        h, w, _ = src.shape
        img = normalized_np(imresize(src, self._width, self._height, interp=9), self._mean, self._std)
        if idx is not None:
            return img, self.label(label, w, h), idx
        return img, self.label(label, w, h)


class YOLO3VideoTrainTransform(YOLO3DefaultTrainTransform):
    """The train augmentation of a window (videoyolo_tpu/data/transforms.py:
    530-572): one plan, drawn as the 2D transform draws it (geometry,
    filter, then colour: the JAX video transform's order), applied to each
    of the k frames; the label is the key frame's, or with mult_out the list
    of each frame's labels, which the one plan moves alike (the crop's IoU
    constraints over all of their boxes).  `apply` takes the
    decoded (k, h, w, 3) window and returns (uint8 (k, H, W, 3), bbox,
    colour map) with `device_color`, else the normalised float32 window."""

    def __init__(self, k, width, height, rs: np.random.RandomState, rnd: random.Random,
                 mean=MEAN, std=STD, device_color: bool = True):
        super().__init__(width, height, rs, rnd, mean, std, device_color)
        self._k = k

    @property
    def k(self) -> int:
        return self._k

    def apply(self, src, plan):
        bbox, rect, flip, interp, mat = plan
        imgs = np.stack([native.crop_resize_pad(f, rect, self._height, self._width, interp, self.fill, flip)
                         for f in src])
        if self._device_color:
            return imgs, _float32(bbox), mat
        return apply_color_np(imgs, mat), _float32(bbox)


class YOLO3VideoInferenceTransform(YOLO3DefaultInferenceTransform):
    """Resize (interp 9) and normalise each frame of a (k, H, W, 3) window
    (videoyolo_tpu/data/transforms.py:575-589); the label (or each frame's,
    with mult_out) scales from the frames' size."""

    def __call__(self, src, label, idx=None):
        _, h, w, _ = src.shape
        imgs = np.stack([normalized_np(imresize(f, self._width, self._height, interp=9), self._mean, self._std)
                         for f in src])
        if idx is not None:
            return imgs, self.label(label, w, h), idx
        return imgs, self.label(label, w, h)


# --------------------------------------------------------------------------
# mixup (videoyolo_tpu/data/transforms.py:623-684)
# --------------------------------------------------------------------------

def with_mix_column(label: np.ndarray, ratio: float) -> np.ndarray:
    """`label` with the mix ratio appended as its last column."""
    return np.hstack((label, np.full((label.shape[0], 1), ratio, label.dtype)))


def check_mixable(frames: int):
    """Mixup blends single images.  The JAX package's `MixupDetection._mix`
    builds an (H, W, 3) canvas from the first two axes of what the dataset
    gives, so a (k, H, W, 3) window raises a numpy broadcasting ValueError
    there; the port raises this ValueError instead, before drawing
    anything."""
    if frames != 1:
        raise ValueError(
            f"mixup blends single images, got windows of {frames} frames: the JAX package's MixupDetection "
            "fails on windows (--mixup with --window), and so does the port"
        )


def mix_pixels(img1: np.ndarray, img2: np.ndarray, lambd: float) -> np.ndarray:
    """lambd * img1 + (1 - lambd) * img2 on a canvas of the larger height
    and width, in float32, rounded back to img1's dtype (uint8: truncated,
    as the JAX package does)."""
    height = max(img1.shape[0], img2.shape[0])
    width = max(img1.shape[1], img2.shape[1])
    mix_img = np.zeros((height, width, 3), np.float32)
    mix_img[: img1.shape[0], : img1.shape[1]] += img1.astype(np.float32) * lambd
    mix_img[: img2.shape[0], : img2.shape[1]] += img2.astype(np.float32) * (1 - lambd)
    return mix_img.astype(img1.dtype)


def mix_labels(label1: np.ndarray, label2: np.ndarray, lambd: float) -> np.ndarray:
    """Both images' boxes, each with its image's ratio as the last column."""
    return np.vstack((with_mix_column(label1, lambd), with_mix_column(label2, 1 - lambd)))


class MixupDetection:
    """A dataset wrapper that blends each image with a random partner:
    ratio lambd ~ beta(alpha, beta), clipped to [0, 1], appended to every
    label row as its last column (1 for an image not blended).  The mixed
    image is rounded back to uint8 (the JAX package's contract, so that
    batches stay uint8 with the colour map applied on the device).

    The draws come from `rs` (JAX: the global `np.random`), beta first,
    then the partner's index; `draw` makes them alone, so the loader can
    take them, with the plans, when it submits a batch.  `set_mixup(False)`
    (the train twin's last --no_mixup_epochs) keeps every image unblended
    and draws nothing."""

    def __init__(self, dataset, rs: np.random.RandomState, mixup_alpha: float = 1.5, mixup_beta: float = 1.5):
        self._dataset = dataset
        self._rs = rs
        self._alpha = mixup_alpha
        self._beta = mixup_beta
        self._enabled = True
        # applied after mixing, set on a per-batch copy, never on the
        # wrapped dataset
        self._transform = None

    @property
    def dataset(self):
        """The wrapped dataset."""
        return self._dataset

    def set_mixup(self, enabled: bool):
        self._enabled = enabled

    def __len__(self):
        return len(self._dataset)

    def __getattr__(self, item):
        # no dunder delegation: copy and pickle probe __getstate__ and the
        # like on a half-built instance
        if item.startswith("__"):
            raise AttributeError(item)
        try:
            ds = object.__getattribute__(self, "_dataset")
        except AttributeError:
            raise AttributeError(item) from None
        return getattr(ds, item)

    def draw(self):
        """(lambd, partner index or None): None when the image stays as it
        is (mixup off, or lambd clipped to 1)."""
        if not self._enabled:
            return 1.0, None
        lambd = max(0.0, min(1.0, self._rs.beta(self._alpha, self._beta)))
        if lambd >= 1:
            return lambd, None
        return lambd, int(self._rs.randint(0, len(self._dataset)))

    def __getitem__(self, idx):
        img1, label1 = self._dataset[idx][:2]
        check_mixable(img1.shape[0] if img1.ndim == 4 else 1)
        lambd, idx2 = self.draw()
        if idx2 is None:
            img, label = img1, with_mix_column(label1, 1.0)
        else:
            img2, label2 = self._dataset[idx2][:2]
            img, label = mix_pixels(img1, img2, lambd), mix_labels(label1, label2, lambd)
        if self._transform is not None:
            return self._transform(img, label)  # (img, label[, colour map])
        return img, label
