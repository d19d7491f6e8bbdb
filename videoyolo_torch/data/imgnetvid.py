"""ImageNet-VID video object detection dataset, frames and windows of
frames (port of videoyolo_tpu/data/imgnetvid.py:30-526).

Each sample is one frame, keyed by its frame id (the second column of
`ImageSets/VID/<split>.txt`, whose first column is `<video>/<frame>`), or,
with `window=(k, step)` and k > 1, the window of k frames of its video
centred on it, every `step`-th, clamped at the video's ends (the sampler of
videoyolo_tpu/data/imgnetvid.py:337-356), labelled by the key frame:

  * `every` keeps the frames whose number is a multiple of it, and
    `frames_per_video` keeps about that many frames of each video;
  * `allow_empty` ([-1] * 6 rows for a frame without boxes; otherwise the
    list of non-empty frames is cached as `ImageSets/VID/<split>[_every
    N][_fpvN]_nonempty.txt` in the JAX package's format);
  * the labels carry each box's track id as their last column, which
    `__getitem__`, `label_and_size` and `get_label` strip;
  * `motion_ious`: each frame's boxes' mean IoU with their track in the
    frames +-10, read from `<root>/<split>_motion_ious.json` and written by
    `generate_motion_ious` when missing (the FGFA protocol).

Images are `Data/VID/<split>/<video>/<frame>.JPEG`, decoded by the JPEG
core; a window's sample is its k frames stacked (k, H, W, 3), and
`window_paths` names them.  Windows keep every frame (`allow_empty` is
forced on, as in the JAX package).  With `mult_out` a window carries the
labels of each of its frames (videoyolo_tpu/data/imgnetvid.py:114-155):
`__getitem__` and `label_and_size` give a list of k labels, `sample_path`
the k frames' paths and `get_sample_ids` the k frame ids of each window,
for YOLOv3Temporal's per-timestep heads.  With `videos=True` each sample
is a whole video (videoyolo_tpu/data/imgnetvid.py:195-218), keyed by its
name: `__getitem__` gives its frames stacked (n, H, W, 3), each through the
transform, and their labels, track ids kept, each padded to 20 rows with -1
(n, 20, 6); `every` keeps the frames whose number is a multiple of it
within each video, and `sample_path` is `<split>/<video>`.  Pre-extracted
features (`features_dir`) come with ROADMAP.md Queue 1 item 13 and raise
NotImplementedError.
"""
from __future__ import annotations

import json
import logging
import math
import os
import xml.etree.ElementTree as et
from typing import Dict, List, Optional

import numpy as np

from .base import DetectionDataset, load_names, read_image


class ImageNetVidDetection(DetectionDataset):
    name = "vid"

    def __init__(
        self,
        root=os.path.join("datasets", "ImageNetVID", "ILSVRC"),
        splits=((2017, "train"),),
        allow_empty: bool = True,
        videos: bool = False,
        transform=None,
        index_map=None,
        every: int = 1,
        frames_per_video: int = 0,
        inference: bool = False,
        window=(1, 1),
        features_dir: Optional[str] = None,
        mult_out: bool = False,
    ):
        if mult_out and int(window[0]) <= 1:
            raise ValueError("mult_out labels each frame of a window: it needs window=(k, step) with k > 1")
        if features_dir is not None:
            raise NotImplementedError(
                "VID with pre-extracted features (features_dir) comes with the extract twin, "
                "ROADMAP.md Queue 1 item 13"
            )
        if len(splits) != 1:
            raise ValueError("one split at a time: the frame ids of two splits collide")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if frames_per_video > 0 and (every != 1 or videos):
            raise ValueError("frames_per_video excludes every and videos")
        super().__init__(transform=transform, inference=inference)
        self.root = os.path.expanduser(root)
        self._splits = list(splits)
        self._window_size, self._window_step = int(window[0]), int(window[1])
        self._mult_out = mult_out
        self._videos = videos
        if self._window_size > 1 or videos:
            allow_empty = True  # a window's or a video's frames are all kept (imgnetvid.py:57-58)
        self._allow_empty = allow_empty
        self._coco_path = os.path.join(
            self.root, "jsons", "_".join(str(s[0]) + s[1] for s in self._splits) + ".json"
        )
        self._annotations_path = os.path.join(self.root, "Annotations", "VID", "{}", "{}", "{}.xml")
        self._image_path = os.path.join(self.root, "Data", "VID", "{}", "{}", "{}.JPEG")
        self.index_map = index_map or dict(zip(self.wn_classes, range(self.num_class)))
        self.videos = self._load_videos()
        self.samples = {
            frame_id: (video[0], video[1], frame_name)
            for video in self.videos.values()
            for frame_name, frame_id in zip(video[2], video[3])
        }
        self.all_samples = dict(self.samples)
        self._windows = self._window_ids() if self._window_size > 1 else None
        self._every = int(every)
        self._frames_per_video = int(frames_per_video)
        if videos:
            # each video's frames whose number is a multiple of `every`
            self.samples = {
                name: [v[0], v[1], [f for f in v[2] if int(f) % self._every == 0],
                       [i for f, i in zip(v[2], v[3]) if int(f) % self._every == 0]]
                for name, v in self.videos.items()
            }
        elif every != 1:
            self.samples = {k: v for k, v in self.samples.items() if int(v[-1]) % self._every == 0}
        if self._frames_per_video > 0:
            self.samples = self._per_video_count(self.samples, self._frames_per_video)
        self.sample_ids = sorted(self.samples.keys())
        self._labels = {}  # frame id -> parsed rows, filled below
        for sid in self.sample_ids:
            if not videos:
                self._label_for_sid(sid)
            elif self.samples[sid][3]:  # a video's size is its first frame's
                self._label_for_sid(self.samples[sid][3][0])
                if self.samples[sid][3][0] in self._im_shapes:
                    self._im_shapes[sid] = self._im_shapes[self.samples[sid][3][0]]
        if not allow_empty:
            self.samples, self.sample_ids = self._remove_empties()

    @property
    def classes(self) -> List[str]:
        return load_names("imagenetvid")

    @property
    def wn_classes(self) -> List[str]:
        return load_names("imagenetvid_wn")

    @property
    def motion_ious(self):
        """Each frame's boxes' mean track IoU, keyed by the frame id as a
        string (written by `generate_motion_ious` when missing)."""
        path = os.path.join(self.root, f"{self._splits[0][1]}_motion_ious.json")
        if not os.path.exists(path):
            generate_motion_ious(self.root, self._splits[0][1])
        with open(path) as f:
            return json.load(f)

    def __len__(self):
        return len(self.sample_ids)

    def get_label(self, sid):
        return self._label_for_sid(sid)[:, :-1]

    def get_sample_ids(self):
        """The sample ids; with mult_out each window's k frame ids."""
        if self._mult_out:
            return [self._windows[sid] for sid in self.sample_ids]
        return self.sample_ids

    @property
    def window(self):
        """(k, step) of the windows; k = 1 for single frames."""
        return self._window_size, self._window_step

    @property
    def mult_out(self) -> bool:
        return self._mult_out

    def sample_path(self, idx):
        """The (key) frame's path; with mult_out the window's k paths; for a
        video `<split>/<video>`."""
        if self._videos:
            return os.path.join(*self.samples[self.sample_ids[idx]][:2])
        if self._mult_out:
            return self.window_paths(idx)
        return self._image_path.format(*self.samples[self.sample_ids[idx]])

    def window_paths(self, idx):
        """The paths of the window's k frames, in time order."""
        return [self._image_path.format(*self.all_samples[sid]) for sid in self._windows[self.sample_ids[idx]]]

    def __getitem__(self, idx):
        if self._videos:
            return self._video_sample(idx)
        label = self.label_and_size(idx)[0]
        if self._window_size > 1:
            img = np.stack([read_image(p) for p in self.window_paths(idx)])
        else:
            img = read_image(self.sample_path(idx))
        return self._transformed(img, label, idx)

    def _video_sample(self, idx):
        """A whole video: its frames, each through the transform, stacked,
        and their labels padded to 20 rows (videoyolo_tpu/data/imgnetvid.py:
        195-218)."""
        split, video, names, ids = self.samples[self.sample_ids[idx]]
        clip, labels = [], []
        for name, fid in zip(names, ids):
            img, label = read_image(self._image_path.format(split, video, name)), self._label_for_sid(fid)
            if self._transform is not None:
                out = self._transform(img, label)
                if len(out) == 3:
                    raise NotImplementedError("device-colour train transforms are not supported on whole videos "
                                              "(one colour matrix a frame); pass --host_color")
                img, label = out
            labels.append(self._pad_to_dense(label, 20))
            clip.append(img)
        clip, labels = np.stack(clip), np.array(labels)
        return (clip, labels, idx) if self._inference else (clip, labels)

    def _window_ids(self) -> Dict[int, List[int]]:
        """Each frame id's window: k frame ids of its video, every step-th,
        centred on it and clamped to the video's first and last frames; an
        even k drops the last (videoyolo_tpu/data/imgnetvid.py:337-356)."""
        windows = {}
        half, step = self._window_size // 2, self._window_step
        for video in self.videos.values():
            ids = video[3]
            for i in range(len(ids)):
                window = [ids[max(0, i - back)] for back in range(half * step, step - 1, -step)]
                window.append(ids[i])
                for fwd in range(step, half * step + 1, step):
                    if len(window) == self._window_size:
                        break
                    window.append(ids[min(len(ids) - 1, i + fwd)])
                windows[ids[i]] = window
        return windows

    def label_and_size(self, idx):
        """The label as `__getitem__` gives it (no track id; with mult_out
        the list of the window's frames' labels) and the (key) frame's size
        from the XML."""
        sid = self.sample_ids[idx]
        size = self._im_shapes.get(sid)
        if self._mult_out:
            label = [self._label_for_sid(f)[:, :-1] for f in self._windows[sid]]
        else:
            label = self._load_label(idx)[:, :-1]
        return label, (None if size is None else tuple(size))

    def _per_video_count(self, samples, count):
        """About `count` frames of each video: a stride of ceil(len / count)
        within it."""
        by_clip: Dict[str, list] = {}
        for k in sorted(samples):  # ids follow the split file: video-major
            by_clip.setdefault(samples[k][1], []).append(k)
        keep = set()
        for ks in by_clip.values():
            step = max(1, int(math.ceil(len(ks) / float(count))))
            keep.update(ks[::step])
        return {k: v for k, v in samples.items() if k in keep}

    def _remove_empties(self):
        """Drop the frames without a box, through the cached list of the
        non-empty ones, named after the subsampling."""
        tag = "" if self._every in (1, None) else f"_every{self._every}"
        if self._frames_per_video:
            tag += f"_fpv{self._frames_per_video}"
        sets = os.path.join(self.root, "ImageSets", "VID")
        not_empty_file = os.path.join(sets, self._splits[0][1] + tag + "_nonempty.txt")
        stats_file = os.path.join(sets, self._splits[0][1] + tag + "_nonempty_stats.txt")
        if os.path.exists(not_empty_file):
            logging.info("Loading splits from: %s", not_empty_file)
            with open(not_empty_file) as f:
                good_sample_ids = [int(line.rstrip()) for line in f if line.strip()]
            stale = [sid for sid in good_sample_ids if sid not in self.samples]
            if stale:
                logging.warning(
                    "%s: %d cached ids are not in the current sample set (stale cache from different "
                    "settings?); ignoring them; delete the file to rebuild", not_empty_file, len(stale),
                )
                good_sample_ids = [sid for sid in good_sample_ids if sid in self.samples]
        else:
            good_sample_ids, removed, n_boxes = [], 0, 0
            for sid in self.sample_ids:
                n = len([b for b in self._label_for_sid(sid) if b[4] >= 0])
                if n < 1:
                    removed += 1
                else:
                    n_boxes += n
                    good_sample_ids.append(sid)
            msg = (
                f"Removed {removed} out of {len(self.sample_ids)} images, leaving "
                f"{len(good_sample_ids)} with {n_boxes} boxes over {len(self.classes)} classes.\n"
            )
            os.makedirs(os.path.dirname(not_empty_file), exist_ok=True)
            with open(not_empty_file, "w") as f:
                f.writelines(f"{sid}\n" for sid in good_sample_ids)
            with open(stats_file, "w") as f:
                f.write(msg)
        good_samples = {sid: self.samples[sid] for sid in good_sample_ids}
        return good_samples, good_sample_ids

    def _load_videos(self) -> Dict[str, list]:
        """The split file -> {video: [split, video, frame names, frame ids]}
        in the file's order (2015 splits keep the ILSVRC2015 videos)."""
        ids = []
        for year, split in self._splits:
            lf = os.path.join(self.root, "ImageSets", "VID", split + ".txt")
            logging.info("Loading splits from: %s", lf)
            with open(lf) as f:
                ids_ = [(int(line.split()[1]), split, line.split()[0]) for line in f if line.strip()]
            if year == 2015:
                ids_ = [i for i in ids_ if "ILSVRC2015" in i[-1]]
            ids += ids_
        videos: Dict[str, list] = {}
        for frame_id, split, name in ids:
            vid_id, frame = name[:-7], name[-6:]
            if vid_id not in videos:
                videos[vid_id] = [split, vid_id, [], []]
            videos[vid_id][2].append(frame)
            videos[vid_id][3].append(frame_id)
        return videos

    def _load_label(self, idx):
        return self._label_for_sid(self.sample_ids[idx])

    def _label_for_sid(self, sample_id):
        """A frame's label rows (with track ids), parsed once."""
        cached = self._labels.get(sample_id)
        if cached is None:
            cached = self._labels[sample_id] = self._parse_label(sample_id)
        return cached.copy()

    def _parse_label(self, sample_id):
        anno_path = self._annotations_path.format(*self.all_samples[sample_id])
        if not os.path.exists(anno_path):
            return np.array([[-1, -1, -1, -1, -1, -1]], dtype=np.float64)
        root = et.parse(anno_path).getroot()
        size = root.find("size")
        width = float(size.find("width").text)
        height = float(size.find("height").text)
        if sample_id not in self._im_shapes:
            self._im_shapes[sample_id] = (width, height)
        label = []
        for obj in root.iter("object"):
            cls_name = obj.find("name").text.strip().lower()
            if cls_name not in self.index_map:
                continue
            cls_id = self.index_map[cls_name]
            trk_id = int(obj.find("trackid").text)
            xml_box = obj.find("bndbox")
            xmin = float(xml_box.find("xmin").text)
            ymin = float(xml_box.find("ymin").text)
            xmax = float(xml_box.find("xmax").text)
            ymax = float(xml_box.find("ymax").text)
            xmin, ymin, xmax, ymax = self._validate_box(xmin, ymin, xmax, ymax, width, height)
            label.append([xmin, ymin, xmax, ymax, cls_id, trk_id])
        if self._allow_empty and len(label) < 1:
            label.append([-1, -1, -1, -1, -1, -1])
        return np.array(label) if label else np.zeros((0, 6))

    @staticmethod
    def _validate_box(xmin, ymin, xmax, ymax, width, height):
        if not 0 <= xmin < width or not 0 <= ymin < height or not xmin < xmax <= width or not ymin < ymax <= height:
            xmin = min(max(0, xmin), width - 1)
            ymin = min(max(0, ymin), height - 1)
            xmax = min(max(xmin + 1, xmax), width)
            ymax = min(max(ymin + 1, ymax), height)
        return xmin, ymin, xmax, ymax

    @staticmethod
    def _pad_to_dense(labels, maxlen=100):
        x = -np.ones((maxlen, 6))
        for enu, row in enumerate(labels[:maxlen]):
            x[enu, :] += row + 1
        return x

    def image_size(self, sample_id):
        return self._im_shapes[sample_id]

    def _coco_json_path(self):
        return self._coco_path

    def stats(self):
        """Video, frame, box and track-instance counts."""
        cls_boxes = []
        n_boxes = [0] * len(self.classes)
        vids = set()
        vid_instances = [set() for _ in self.classes]
        n_frames = 0
        for sample_id in self.sample_ids:
            vid_id = self.samples[sample_id][1]
            vids.add(vid_id)
            for fid in self.samples[sample_id][3] if self._videos else [sample_id]:
                n_frames += 1
                for box in self._label_for_sid(fid):
                    if int(box[4]) < 0:
                        continue
                    n_boxes[int(box[4])] += 1
                    vid_instances[int(box[4])].add(vid_id + str(box[-1]))
        n_instances = [len(vi) for vi in vid_instances]
        out = (
            f"{'Split:': <10} {', '.join(str(s[0]) + s[1] for s in self._splits)}\n"
            f"{'Videos:': <10} {len(vids)}\n"
            f"{'Frames:': <10} {n_frames}\n"
            f"{'Boxes:': <10} {sum(n_boxes)}\n"
            f"{'Instances:': <10} {sum(n_instances)}\n"
            f"{'Classes:': <10} {len(self.classes)}\n"
        ) + "-" * 35 + "\n"
        for i, (nb, ni) in enumerate(zip(n_boxes, n_instances)):
            out += f"{i: <3} {self.wn_classes[i]: <10} {self.classes[i]: <15} {nb: <10} {ni}\n"
            cls_boxes.append([i, self.wn_classes[i], self.classes[i], nb, ni])
        out += "-" * 35 + "\n"
        return out, cls_boxes


def _single_iou(bb, bbgt):
    """+1-convention IoU of the FGFA motion-IoU ground truth."""
    ov = 0.0
    iw = np.min((bb[2], bbgt[2])) - np.max((bb[0], bbgt[0])) + 1
    ih = np.min((bb[3], bbgt[3])) - np.max((bb[1], bbgt[1])) + 1
    if iw > 0 and ih > 0:
        intersect = iw * ih
        ua = (
            (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
            + (bbgt[2] - bbgt[0] + 1.0) * (bbgt[3] - bbgt[1] + 1.0)
            - intersect
        )
        ov = intersect / ua
    return ov


def generate_motion_ious(root, split):
    """Write `<root>/<split>_motion_ious.json` (videoyolo_tpu/data/
    imgnetvid.py:492-526, FGFA-compatible): for every box with a track id,
    its mean IoU with the same track in the frames +-10 of its video; one
    list per frame, keyed 1, 2, ... over the videos in sorted order and
    their frames in the split file's order.  The JAX package walks the
    videos with their pixels decoded; the IoUs need only the labels, read
    here as its whole-video samples give them (the first 20 boxes of a
    frame), so the file is the same byte for byte."""
    dataset = ImageNetVidDetection(root=root, splits=[(2017, split)], allow_empty=True)
    all_ious = {}
    sample_id = 1
    for vid_id in sorted(dataset.videos):
        video = [dataset._pad_to_dense(dataset._label_for_sid(fid), 20) for fid in dataset.videos[vid_id][3]]
        for frame in range(len(video)):
            frame_ious = []
            for box_idx in range(len(video[frame])):
                trk_id = video[frame][box_idx][5]
                if trk_id > -1:
                    ious = []
                    for i in range(-10, 11):
                        frame_c = frame + i
                        if 0 <= frame_c < len(video) and i != 0:
                            for c_box_idx in range(len(video[frame_c])):
                                if video[frame_c][c_box_idx][5] == trk_id:
                                    ious.append(_single_iou(video[frame][box_idx], video[frame_c][c_box_idx]))
                                    break
                    frame_ious.append(np.mean(ious) if ious else 0.0)
            all_ious[sample_id] = frame_ious if frame_ious else [0.0]
            sample_id += 1
    out = os.path.join(root, f"{split}_motion_ious.json")
    with open(out, "w") as f:
        json.dump(all_ious, f)
    return out
