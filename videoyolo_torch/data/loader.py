"""The input pipeline: fixed-shape batches from the JPEG core with a bounded
window of batches in flight (port of videoyolo_tpu/data/loader.py:41-336).

  * a thread pool decodes batches ahead, with at most num_workers +
    PREFETCH batches in flight, yielded in order;
  * labels are padded with -1 to `max_boxes` rows (one shape per bucket),
    twice as many under mixup, whose pairs carry both images' boxes;
  * `shape_sizes` / `shape_interval`: a seeded draw of a shape bucket
    every `shape_interval` batches (the reference's
    RandomTransformDataLoader); unshuffled loaders keep the first bucket;
  * `last_batch` "keep" or "discard", `sampler(epoch)` and `num_samples`
    as in the JAX loader.

Three routes, all through the JPEG core (native.py):

  * the inference batch, `native_decode=(h, w)`: decode, resize with
    imresize(interp=9) and normalise, plus the labels scaled to (w, h)
    from each image's decoded size;
  * the train batch, a train transform with `device_color` on a dataset
    with `native_train_ok` and no mixup: the plans are sampled from the
    labels and the sizes in the annotations, then decode, crop, resize and
    flip in the core's threads give uint8 pixels with a colour map per
    image;
  * the per-sample route, for every other train batch (COCO, ImageNet-DET
    and -VID, any dataset under mixup or with the colour map applied on
    the host): each image's plan, and under mixup its blend's draws, are
    sampled from its label and the size in its JPEG header; a worker then
    decodes it (and its partner), blends the pair, and cuts the tile with
    the core's resampler (native.crop_resize_pad, where the JAX package
    calls cv2), giving uint8 pixels with a colour map, or normalised
    float32 pixels (`device_color=False`).  `gt_mix` carries the blend
    ratios under mixup.  With a video train transform (one with `k`), a
    sample is a window of VID frames: the plan is drawn from the key
    frame's label and header, and the worker decodes the k frames and cuts
    each with the sample's plan, giving (B, k, H, W, 3) batches with one
    colour map a window; mixup raises on windows, as the JAX package's
    MixupDetection fails on them;
  * the per-sample inference route, `inference_transform` (a
    YOLO3VideoInferenceTransform: the JAX detect CLI's route for windows,
    detect_yolo3.py:989-992): the labels now, then in a worker the k
    frames decoded, each resized (interp 9) and normalised, (B, k, H, W, 3)
    float32 with `idx`.

The JAX loader samples the plans (and the blends) in its worker threads;
the port samples each batch's in the order the batches are submitted, so
one seed gives one epoch whatever the number of workers (the JAX package's
at num_workers=1).
"""
from __future__ import annotations

import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from .base import check_jpeg
from .transforms import MixupDetection, check_mixable, mix_labels, mix_pixels, with_mix_column

__all__ = ["pad_labels", "collate_detection", "DetectionLoader"]

PREFETCH = 2  # batches in flight beyond one a worker


def pad_labels(labels: Sequence[np.ndarray], max_boxes: int) -> np.ndarray:
    """Stack variable-length (N_i, D) labels into (B, max_boxes, D), -1 pad.
    An image with more than `max_boxes` boxes is truncated, with a warning."""
    d = max((l.shape[1] for l in labels if l.size), default=6)
    out = np.full((len(labels), max_boxes, d), -1.0, np.float32)
    for i, l in enumerate(labels):
        n = min(len(l), max_boxes)
        if len(l) > max_boxes:
            warnings.warn(
                f"ground-truth labels truncated: an image carries {len(l)} boxes > "
                f"max_boxes={max_boxes}; raise max_boxes (--max_boxes)",
                stacklevel=2,
            )
        if n:
            out[i, :n, : l.shape[1]] = l[:n]
    return out


def collate_detection(samples, max_boxes: int = 56, mixup: bool = False) -> Dict[str, np.ndarray]:
    """(uint8 img, label, (3, 4) colour map), (float32 img, label) or
    (float32 img, label, idx) samples -> a fixed-shape batch dict; an img is
    an image (H, W, 3) or a window (k, H, W, 3), stacked to (B, ...);
    `mixup` adds `gt_mix`, the labels' last column, and an idx `idx`.  A
    label that is a list (a window's per-frame labels, mult_out) gives
    (B, k, max_boxes, D) labels (videoyolo_tpu/data/loader.py:70-95)."""
    if isinstance(samples[0][1], (list, tuple)):
        labels = np.stack([pad_labels([np.atleast_2d(l) for l in s[1]], max_boxes) for s in samples])
    else:
        labels = pad_labels([np.atleast_2d(s[1]) for s in samples], max_boxes)
    color = len(samples[0]) > 2 and getattr(samples[0][2], "shape", None) == (3, 4)
    imgs = np.stack([s[0] for s in samples])
    batch = {
        "image": imgs if color else imgs.astype(np.float32),
        "gt_boxes": labels[..., :4],
        "gt_ids": labels[..., 4:5],
        "label": labels,
    }
    if mixup:
        batch["gt_mix"] = labels[..., -1:]
    if color:
        batch["color"] = np.stack([s[2] for s in samples])
    elif len(samples[0]) > 2:
        batch["idx"] = np.asarray([s[2] for s in samples], np.int64)
    return batch


class DetectionLoader:
    """Iterable over fixed-shape batches with bounded background decode.

    transform_factory: (width, height) -> train transform with `plan`; one
    per shape bucket group.  native_decode: (h, w) of the inference batch,
    labelled through `label_transform` (a YOLO3DefaultInferenceTransform)
    when given.  inference_transform: a YOLO3VideoInferenceTransform, the
    labelled inference route for windows.  A dataset wrapped in a
    MixupDetection trains with mixup: its blends are drawn by the
    per-sample route and collated as `gt_mix`."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        last_batch: str = "keep",
        max_boxes: int = 56,
        num_workers: int = 4,
        seed: Optional[int] = None,
        transform_factory: Optional[Callable[[int, int], Callable]] = None,
        shape_sizes: Optional[Sequence[int]] = None,
        shape_interval: int = 10,
        native_decode: Optional[Sequence[int]] = None,
        label_transform=None,
        inference_transform=None,
        sampler=None,
        num_samples: Optional[int] = None,
    ):
        if last_batch not in ("keep", "discard"):
            raise ValueError(f"last_batch must be keep or discard, got {last_batch!r}")
        if native_decode is None and transform_factory is None and inference_transform is None:
            raise ValueError("a loader needs native_decode=(h, w), an inference_transform or a train "
                             "transform_factory")
        self._dataset = dataset
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._last_batch = last_batch
        self._mixup = isinstance(dataset, MixupDetection)
        self._max_boxes = max_boxes * 2 if self._mixup else max_boxes
        self._num_workers = max(1, num_workers)
        self._rng = np.random.RandomState(seed)
        self._transform_factory = transform_factory
        self._shape_sizes = list(shape_sizes) if shape_sizes else None
        self._shape_interval = max(1, shape_interval)
        self._native_hw = tuple(native_decode) if native_decode else None
        self._label_transform = label_transform
        self._inference_tf = inference_transform
        self._sampler = sampler
        self._num_samples = num_samples
        self._epoch = 0

    def __len__(self):
        n = self._num_samples if self._num_samples is not None else len(self._dataset)
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + self._batch_size - 1) // self._batch_size

    def _batch_indices(self):
        if self._sampler is not None:
            idxs = np.asarray(self._sampler(self._epoch))
            self._epoch += 1
        else:
            idxs = np.arange(len(self._dataset))
            if self._shuffle:
                self._rng.shuffle(idxs)
        batches = []
        for i in range(0, len(idxs), self._batch_size):
            chunk = idxs[i : i + self._batch_size]
            if len(chunk) < self._batch_size and self._last_batch == "discard":
                continue
            batches.append(chunk)
        return batches

    def _plan(self) -> List[Tuple[np.ndarray, Optional[Callable]]]:
        """One epoch's (index_chunk, transform) pairs: a bucket drawn every
        `shape_interval` batches; unshuffled loaders keep bucket 0."""
        plan = []
        tf = None
        for bi, chunk in enumerate(self._batch_indices()):
            if self._transform_factory is not None and self._shape_sizes:
                if tf is None or bi % self._shape_interval == 0:
                    if self._shuffle and len(self._shape_sizes) > 1:
                        size = int(self._rng.choice(self._shape_sizes))
                    else:
                        size = int(self._shape_sizes[0])
                    tf = self._transform_factory(size, size)
            plan.append((chunk, tf))
        return plan

    def _job(self, chunk, transform) -> Callable[[], Dict[str, np.ndarray]]:
        """What a batch needs from the host's state, taken now (the plans
        are drawn here, in submission order); returns the decode to run
        in a worker."""
        if self._inference_tf is not None:
            return self._window_inference_job(chunk)
        paths = [check_jpeg(self._key_path(int(j))) for j in chunk]
        if self._native_hw is not None:
            labels = [self._dataset.label_and_size(int(j))[0] for j in chunk]
            return lambda: self._inference_batch(chunk, paths, labels)
        if transform is None or not hasattr(transform, "plan"):
            raise ValueError("the train route needs a transform with plan (YOLO3DefaultTrainTransform)")
        if self._mixup or not transform.device_color or not getattr(self._dataset, "native_train_ok", False):
            return self._sample_job(chunk, paths, transform)
        rects, flips, interps, bboxes, mats = [], [], [], [], []
        for j, path in zip(chunk, paths):
            label, size = self._dataset.label_and_size(int(j))
            if size is None:
                raise ValueError(f"{path}: no image size without decoding; the train route plans from it")
            w, h = size
            bbox, rect, flip, interp, mat = transform.plan(label, int(w), int(h))
            rects.append(rect)
            flips.append(flip)
            interps.append(interp)
            bboxes.append(bbox.astype(np.float32))
            mats.append(mat)
        out_w, out_h = transform.out_wh
        fill = transform.fill

        def decode():
            imgs = native.load_train_batch(
                paths, np.asarray(rects, np.int32), np.asarray(flips, np.uint8),
                np.asarray(interps, np.uint8), out_h, out_w, fill, threads=self._num_workers,
            )
            return collate_detection(
                [(imgs[i], bboxes[i], mats[i]) for i in range(len(paths))], self._max_boxes
            )

        return decode

    def _key_path(self, j: int) -> str:
        """A sample's path, or its key frame's where a window's labels come
        a frame (mult_out: `sample_path` names all k)."""
        path = self._dataset.sample_path(j)
        return path[len(path) // 2] if isinstance(path, list) else path

    def _sample_job(self, chunk, paths, transform) -> Callable[[], Dict[str, np.ndarray]]:
        """The per-sample route (videoyolo_tpu/data/loader.py:236-276): the
        draws now, in the JAX package's order per image (the blend's ratio
        and partner, then the plan); the pixels in the worker."""
        mixer = self._dataset if self._mixup else None
        base = mixer.dataset if mixer is not None else self._dataset
        k = getattr(transform, "k", 1)
        if mixer is not None:
            check_mixable(k)
        specs = []
        for j, path in zip(chunk, paths):
            label = base.label_and_size(int(j))[0]
            h, w = native.image_size(path)
            if k > 1:
                frames = [check_jpeg(p) for p in base.window_paths(int(j))]
                specs.append((frames, None, 1.0, transform.plan(label, w, h)))
                continue
            partner, lambd = None, 1.0
            if mixer is not None:
                lambd, j2 = mixer.draw()
                if j2 is None:
                    label = with_mix_column(label, 1.0)
                else:
                    partner = check_jpeg(base.sample_path(j2))
                    label = mix_labels(label, base.label_and_size(j2)[0], lambd)
                    h2, w2 = native.image_size(partner)
                    h, w = max(h, h2), max(w, w2)
            specs.append((path, partner, lambd, transform.plan(label, w, h)))

        def decode():
            samples = []
            for path, partner, lambd, plan in specs:
                if k > 1:
                    samples.append(transform.apply(np.stack([native.decode(p) for p in path]), plan))
                    continue
                img = native.decode(path)
                if partner is not None:
                    img = mix_pixels(img, native.decode(partner), lambd)
                samples.append(transform.apply(img, plan))
            return collate_detection(samples, self._max_boxes, self._mixup)

        return decode

    def _window_inference_job(self, chunk) -> Callable[[], Dict[str, np.ndarray]]:
        """The inference route for windows: the labels now, the frames in
        the worker (decode, resize with interp 9, normalise each)."""
        specs = [([check_jpeg(p) for p in self._dataset.window_paths(int(j))],
                  self._dataset.label_and_size(int(j))[0], int(j)) for j in chunk]

        def decode():
            return collate_detection(
                [self._inference_tf(np.stack([native.decode(p) for p in frames]), label, j)
                 for frames, label, j in specs], self._max_boxes)

        return decode

    def _inference_batch(self, chunk, paths, labels):
        h, w = self._native_hw
        imgs, sizes = native.load_batch(paths, h, w)
        batch = {"image": imgs, "idx": np.asarray([int(j) for j in chunk], np.int64)}
        if self._label_transform is not None:
            resized = [self._label_transform.label(l, sw, sh) for l, (sh, sw) in zip(labels, sizes)]
            padded = pad_labels([np.atleast_2d(l) for l in resized], self._max_boxes)
            batch.update(gt_boxes=padded[..., :4], gt_ids=padded[..., 4:5], label=padded)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        plan = iter(self._plan())
        if self._num_workers <= 1:
            for chunk, tf in plan:
                yield self._job(chunk, tf)()
            return
        # a bounded window of batches in flight, yielded in submission order
        max_inflight = self._num_workers + PREFETCH
        with ThreadPoolExecutor(self._num_workers) as pool:
            inflight: deque = deque()
            for item in plan:
                inflight.append(pool.submit(self._job(*item)))
                if len(inflight) >= max_inflight:
                    break
            while inflight:
                batch = inflight.popleft().result()  # re-raises worker errors
                nxt = next(plan, None)
                if nxt is not None:
                    inflight.append(pool.submit(self._job(*nxt)))
                yield batch
