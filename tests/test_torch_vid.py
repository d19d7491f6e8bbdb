"""The port's ImageNet-VID frames dataset and the VID motion metric against
the JAX package's on the CPU: samples and labels under `every`,
`frames_per_video` and the non-empty cache, the motion-IoU json, and the
metric's AP table, agnostic and per class.  The tree is written with cv2
at 80-128 px."""
import json
import os

import cv2
import numpy as np
import pytest

from videoyolo_tpu.data.imgnetvid import ImageNetVidDetection as JaxVID
from videoyolo_tpu.data.imgnetvid import generate_motion_ious as jax_generate_motion_ious
from videoyolo_tpu.metrics.imgnetvid import VIDDetectionMetric as JaxVIDMetric
from videoyolo_tpu.metrics.imgnetvid import vid_eval_motion as jax_vid_eval_motion
from videoyolo_torch.data.base import load_names
from videoyolo_torch.data.imgnetvid import ImageNetVidDetection, generate_motion_ious
from videoyolo_torch.metrics.imgnetvid import VIDDetectionMetric, vid_eval_motion
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

VID_SPLITS = (("train", 2, 10), ("val", 3, 12))  # (split, videos, frames a video)


def write_vid_tree(root, seed=0, splits=VID_SPLITS, size=(96, 128), gaps=True):
    """`root`/ImageNetVID/ILSVRC: for each split `videos` videos of
    `frames` cv2 .JPEG frames listed in `ImageSets/VID/<split>.txt` with
    frame ids 1, 2, ... in sorted video order, and per frame an XML of 1-3
    tracks moving across it (WordNet names, track ids); one box goes beyond
    the image.  With `gaps`, tracks start and end within the video, some
    frames hold no object, one has no XML and one object's class is
    unknown; without, the first track spans every frame."""
    rng = np.random.RandomState(seed)
    wn = load_names("imagenetvid_wn")
    base = os.path.join(root, "ImageNetVID", "ILSVRC")
    os.makedirs(os.path.join(base, "ImageSets", "VID"), exist_ok=True)
    h, w = size
    for split, n_videos, n_frames in splits:
        lines, frame_id = [], 1
        for v in range(n_videos):
            video = f"ILSVRC2015_{split}_{v:08d}"
            for d in ("Data", "Annotations"):
                os.makedirs(os.path.join(base, d, "VID", split, video), exist_ok=True)
            tracks = []
            for t in range(1 + (v + 1) % 3):
                bw, bh = rng.randint(16, w // 2), rng.randint(16, h // 2)
                tracks.append(dict(cls=wn[int(rng.randint(0, len(wn)))], x=rng.uniform(0, w - bw),
                                   y=rng.uniform(0, h - bh), w=bw, h=bh, vx=rng.uniform(-4, 4),
                                   vy=rng.uniform(-3, 3), first=int(rng.randint(0, 3)) if gaps or t else 0,
                                   last=n_frames - (int(rng.randint(0, 3)) if gaps or t else 0)))
            for f in range(n_frames):
                frame = f"{f:06d}"
                lines.append(f"{video}/{frame} {frame_id}")
                frame_id += 1
                cv2.imwrite(os.path.join(base, "Data", "VID", split, video, frame + ".JPEG"),
                            rng.randint(0, 255, (h, w, 3), np.uint8))
                if gaps and v == 0 and f == 5:
                    continue  # no XML
                objs = ""
                for t, tr in enumerate(tracks):
                    if not tr["first"] <= f < tr["last"] or (gaps and v == 1 and 3 <= f < 6):
                        continue
                    x0 = int(np.clip(tr["x"] + tr["vx"] * f, 0, w - tr["w"]))
                    y0 = int(np.clip(tr["y"] + tr["vy"] * f, 0, h - tr["h"]))
                    x1, y1 = x0 + tr["w"], y0 + tr["h"]
                    if v == 2 and f == 1 and t == 0:
                        x1 = w + 6  # beyond the image: clipped
                    cls = "n00000000" if (gaps and v == 1 and f == 8 and t == 0) else tr["cls"]
                    objs += (f"<object><trackid>{t}</trackid><name>{cls}</name><bndbox><xmin>{x0}</xmin>"
                             f"<ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>")
                with open(os.path.join(base, "Annotations", "VID", split, video, frame + ".xml"), "w") as fh:
                    fh.write(f"<annotation><size><width>{w}</width><height>{h}</height></size>{objs}</annotation>")
        with open(os.path.join(base, "ImageSets", "VID", split + ".txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return root


def _vid(cls, root, **kw):
    return cls(root=os.path.join(root, "ImageNetVID", "ILSVRC"), **kw)


@pytest.fixture(scope="module")
def vid_root(tmp_path_factory):
    return write_vid_tree(str(tmp_path_factory.mktemp("vid")))


VID_KWARGS = {
    "val": dict(splits=[(2017, "val")], inference=True),
    "every3": dict(splits=[(2017, "val")], every=3),
    "fpv4": dict(splits=[(2017, "val")], frames_per_video=4),
    "train_every2": dict(splits=[(2017, "train")], every=2),
}


@pytest.mark.parametrize("kw", sorted(VID_KWARGS))
def test_vid_frames_match_jax(vid_root, kw):
    """Sample ids, paths, labels with and without track ids, sizes, stats and
    the plain __getitem__, exactly."""
    ours, ref = _vid(ImageNetVidDetection, vid_root, **VID_KWARGS[kw]), _vid(JaxVID, vid_root, **VID_KWARGS[kw])
    assert ours.sample_ids == ref.sample_ids and ours.get_sample_ids() == ref.get_sample_ids()
    assert ours.samples == ref.samples and ours.num_class == 30 and ours.classes == ref.classes
    for i, sid in enumerate(ref.sample_ids):
        assert ours.sample_path(i) == ref.sample_path(i) and ours.sample_path(i).endswith(".JPEG")
        assert np.array_equal(ours._load_label(i), ref._load_label(i))
        assert np.array_equal(ours.get_label(sid), ref.get_label(sid))
        label, size = ours.label_and_size(i)
        assert np.array_equal(label, ref[i][1]) and size == ref._im_shapes.get(sid)
    assert ours.stats() == ref.stats()
    a, b = ours[2], ref[2]
    assert len(a) == len(b) and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("every", [1, 2])
def test_vid_nonempty_cache_matches_jax(tmp_path, every):
    """Without allow_empty: the frames kept, and the cache file each package
    writes (named after `every`), byte for byte; each reads the other's."""
    roots = [write_vid_tree(str(tmp_path / name)) for name in ("ours", "jax")]
    kw = dict(splits=[(2017, "val")], allow_empty=False, every=every)
    ours, ref = _vid(ImageNetVidDetection, roots[0], **kw), _vid(JaxVID, roots[1], **kw)
    assert ours.sample_ids == ref.sample_ids
    assert len(ours) < len(_vid(JaxVID, roots[1], splits=[(2017, "val")], every=every))
    sets = os.path.join("ImageNetVID", "ILSVRC", "ImageSets", "VID")
    names = [n for n in os.listdir(os.path.join(roots[1], sets)) if "nonempty" in n]
    assert sorted(names) == sorted(n for n in os.listdir(os.path.join(roots[0], sets)) if "nonempty" in n)
    for n in names:
        with open(os.path.join(roots[0], sets, n)) as f, open(os.path.join(roots[1], sets, n)) as g:
            assert f.read() == g.read()
    cache = os.path.join(sets, "val" + ("" if every == 1 else f"_every{every}") + "_nonempty.txt")
    for root in roots:
        with open(os.path.join(root, cache), "w") as f:
            f.writelines(f"{sid}\n" for sid in ref.sample_ids[:4])
    assert _vid(JaxVID, roots[0], **kw).sample_ids == ref.sample_ids[:4]
    assert _vid(ImageNetVidDetection, roots[1], **kw).sample_ids == ref.sample_ids[:4]


def test_vid_unported_options_raise(vid_root):
    with pytest.raises(NotImplementedError, match="item 13"):
        _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], features_dir="x")
    # whole videos are ported (streaming; against JAX in tests/test_torch_streaming.py):
    # each video's frames and their labels padded to 20 rows
    videos = _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], videos=True)
    clip, labels = videos[0]
    assert len(videos) == 3 and clip.shape == (12, 96, 128, 3) and labels.shape == (12, 20, 6)
    # windows are ported (tests/test_torch_windows.py), and their per-frame
    # labels (mult_out, tests/test_torch_train_tout.py), which need a window
    assert _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], window=(3, 1)).window == (3, 1)
    assert _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], window=(3, 1), mult_out=True).mult_out
    with pytest.raises(ValueError, match="k > 1"):
        _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], mult_out=True)


def test_generate_motion_ious_matches_jax(tmp_path):
    """The json the port writes from the labels alone equals the one JAX
    writes from its decoded whole-video samples: the same keys, values
    within 1e-12, and in fact the same bytes."""
    roots = [write_vid_tree(str(tmp_path / name)) for name in ("ours", "jax")]
    ours = generate_motion_ious(os.path.join(roots[0], "ImageNetVID", "ILSVRC"), "val")
    ref = jax_generate_motion_ious(os.path.join(roots[1], "ImageNetVID", "ILSVRC"), "val")
    with open(ours) as f, open(ref) as g:
        a_text, b_text = f.read(), g.read()
    a, b = json.loads(a_text), json.loads(b_text)
    assert list(a) == list(b) == [str(i) for i in range(1, 3 * 12 + 1)]
    for k in b:
        assert len(a[k]) == len(b[k]) and np.allclose(a[k], b[k], rtol=0, atol=1e-12)
    assert a_text == b_text
    assert any(0 < v < 1 for vs in a.values() for v in vs)  # the tracks move


def _vid_predictions(ds, rs):
    """Per frame, its gt jittered (some with another class) and random
    boxes, -1 padded to 6 rows."""
    out = []
    for i, sid in enumerate(ds.sample_ids):
        label = ds.get_label(sid)
        rows = [r for r in label if r[4] >= 0]
        boxes = [r[:4] + rs.randn(4) * 3 for r in rows] + [np.sort(rs.uniform(0, 90, 4)) for _ in range(2)]
        ids = [r[4] if rs.rand() < 0.8 else rs.randint(0, 30) for r in rows] + list(rs.randint(0, 30, 2))
        pad = 6 - len(ids)
        out.append((sid, np.concatenate([np.array(boxes).reshape(-1, 4), -np.ones((pad, 4))])[None],
                    np.concatenate([np.array(ids, float), -np.ones(pad)])[None, :, None],
                    np.concatenate([rs.rand(len(ids)), -np.ones(pad)])[None, :, None]))
    return out


@pytest.mark.parametrize("agnostic", [False, True])
def test_vid_metric_matches_jax(tmp_path, agnostic):
    """The same detections through both metrics, each on its own copy of a
    tree whose every frame holds a box: the AP table (motion x area x
    class) within 1e-12 and the same names and values; each metric also
    reads the motion json the other package wrote."""
    roots = [write_vid_tree(str(tmp_path / name), gaps=False) for name in ("ours", "jax")]
    kw = dict(splits=[(2017, "val")], every=2, inference=True)
    ours_ds, ref_ds = _vid(ImageNetVidDetection, roots[0], **kw), _vid(JaxVID, roots[1], **kw)
    preds = _vid_predictions(ours_ds, np.random.RandomState(2))
    ours, ref = VIDDetectionMetric(ours_ds, agnostic=agnostic), JaxVIDMetric(ref_ds, agnostic=agnostic)
    for m in (ours, ref):
        for sid, b, c, s in preds:
            m.update(b, c, s, sid=sid)
    assert ours._results == ref._results
    ap = vid_eval_motion(ours_ds, ours._results, ours._motion_ranges, ours._area_ranges, agnostic=agnostic)
    ap_ref = jax_vid_eval_motion(ref_ds, ref._results, ref._motion_ranges, ref._area_ranges, agnostic=agnostic)
    assert ap.shape == ap_ref.shape == (4, 4, 1 if agnostic else 30)
    assert np.allclose(ap, ap_ref, rtol=0, atol=1e-12) and (ap[0, 0] > 0).any()
    assert ours.get() == ref.get()
    # the motion json each wrote, read by the other
    motion = os.path.join("ImageNetVID", "ILSVRC", "val_motion_ious.json")
    os.replace(os.path.join(roots[0], motion), os.path.join(tmp_path, "m.json"))
    os.replace(os.path.join(roots[1], motion), os.path.join(roots[0], motion))
    os.replace(os.path.join(tmp_path, "m.json"), os.path.join(roots[1], motion))
    assert ours.get() == ref.get()


@pytest.mark.parametrize("agnostic", [False, True])
def test_vid_metric_on_empty_frames_as_jax(vid_root, agnostic):
    """A fault of the reference that the port mirrors: a frame without boxes
    carries allow_empty's [-1] row, which the per-class metric cannot count
    (both raise ValueError) and the agnostic one counts as a gt of its one
    class (both give the same table)."""
    kw = dict(splits=[(2017, "val")], inference=True)
    ours_ds, ref_ds = _vid(ImageNetVidDetection, vid_root, **kw), _vid(JaxVID, vid_root, **kw)
    assert any((ref_ds.get_label(sid)[:, 4] < 0).any() for sid in ref_ds.sample_ids)
    preds = _vid_predictions(ours_ds, np.random.RandomState(3))
    metrics = [VIDDetectionMetric(ours_ds, agnostic=agnostic), JaxVIDMetric(ref_ds, agnostic=agnostic)]
    for m in metrics:
        for sid, b, c, s in preds:
            m.update(b, c, s, sid=sid)
    if not agnostic:
        for m in metrics:
            with pytest.raises(ValueError, match="negative"):
                m.get()
        return
    assert metrics[0].get() == metrics[1].get()


def test_vid_metric_class_map_and_offset_args(tmp_path):
    """class_map (the eval classes onto a model's) and offset pass through
    as in the JAX metric."""
    full_root = write_vid_tree(str(tmp_path), seed=1, gaps=False)
    kw = dict(splits=[(2017, "val")], every=3, inference=True)
    ours_ds, ref_ds = _vid(ImageNetVidDetection, full_root, **kw), _vid(JaxVID, full_root, **kw)
    class_map = [(c * 7) % 31 - 1 for c in range(30)]
    preds = _vid_predictions(ours_ds, np.random.RandomState(4))
    ours = VIDDetectionMetric(ours_ds, class_map=class_map, offset=None)
    ref = JaxVIDMetric(ref_ds, class_map=class_map, offset=None)
    for m in (ours, ref):
        for sid, b, c, s in preds:
            m.update(b, c, s, sid=sid)
    assert ours.get() == ref.get()
