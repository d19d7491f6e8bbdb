"""The port's two entry points on ImageNet-VID windows from disk against the
JAX package's: `python -m videoyolo_torch.detect --dataset vid --window 3,1
...` (its pred/ cache, under each key frame's name, read by
detect_yolo3.py, which writes the same VID and VOC summaries) and `python
-m videoyolo_torch.train_yolov3 --dataset vid --window 3,1 --k_join_pos late
--corr_pos early` as a subprocess for one short epoch, validated on
windows (the JAX package reads its checkpoint).  On the CPU, at 64 px, the
full-width YOLOv3T (k=3, early correlation at d=2) with random weights."""
import os
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import numpy as np
import torch

from test_torch_cli_datasets import _detect_and_jax_evaluate
from test_torch_vid import write_vid_tree
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.train import checkpoint as jckpt

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SIZE = 64
TEMPORAL = ("--window", "3,1", "--k_join_pos", "late", "--corr_pos", "early", "--corr_d", "2")


def test_detect_twin_on_vid_windows_evaluated_by_jax(tmp_path):
    """VID val windows of 3 frames around every 2nd frame: the detections of
    each window cached under its key frame in the `<video>/<frame>` layout,
    and detect_yolo3.py with the same flags reads the cache (no model) and
    writes the same vid.txt and voc.txt."""
    root = write_vid_tree(str(tmp_path / "tree"), seed=8, gaps=False)
    preds, out = _detect_and_jax_evaluate(tmp_path, root, "vid", ["vid", "voc"], extra=("--every", "2", *TEMPORAL))
    videos = sorted(p.name for p in (out / "pred").iterdir())
    assert videos == [f"ILSVRC2015_val_{v:08d}" for v in range(3)]
    assert all(sorted(f.name for f in (out / "pred" / v).glob("*.txt")) == [f"{i:06d}.txt" for i in range(0, 12, 2)]
               for v in videos)
    assert sum(len(v) for v in preds.values()) > 0 and all(p.endswith(".JPEG") for p in preds)


def test_window_metrics_read_the_size_as_jax(tmp_path):
    """detect_yolo3.py scores a window's detections at the size of the
    stacked frames' first two axes, (k, H), not the frame's (H, W): from a
    cache of perfect detections (each key frame's boxes) both packages
    write the same vid.txt and voc.txt, whose mAP is not 1 (ROADMAP.md
    Queue 3: the reference's fault, mirrored)."""
    from videoyolo_torch.data.imgnetvid import ImageNetVidDetection

    root = write_vid_tree(str(tmp_path / "tree"), seed=10, gaps=False)
    ds = ImageNetVidDetection(root=os.path.join(root, "ImageNetVID", "ILSVRC"), splits=[(2017, "val")], every=4,
                              window=(3, 1), inference=True)
    out = tmp_path / "results" / "port"
    for i in range(len(ds)):
        path = ds.sample_path(i)
        label, (w, h) = ds.label_and_size(i)
        f = out / "pred" / path.split("/")[-2] / (os.path.basename(path)[:-5] + ".txt")
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text("".join(f"{path},{int(r[4])},0.9,{r[0] / w},{r[1] / h},{r[2] / w},{r[3] / h}\n" for r in label))
    _detect_and_jax_evaluate(tmp_path, root, "vid", ["vid", "voc"], extra=("--every", "4", *TEMPORAL))
    voc = float((out / "voc.txt").read_text().splitlines()[-1].split(": ")[-1])
    assert voc < 0.5, voc


def _jax_template(num_classes):
    model = JaxYOLOv3T(num_classes=num_classes, k=3, k_join_type="max", k_join_pos="late", corr_pos="early",
                       corr_d=2)
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.PRNGKey(0),
                            np.zeros((1, 3, SIZE, SIZE, 3), np.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_train_twin_vid_windows_subprocess(tmp_path):
    """`python -m videoyolo_torch.train_yolov3 --device cpu --dataset vid
    --window 3,1 --k_join_pos late --corr_pos early --corr_d 2`: one epoch at
    B=2, 64 px, float32, then validation on val windows with VOC mAP; its
    checkpoint under the reference's name loads into the JAX package's
    YOLOv3T of the same flags (30 classes)."""
    root = write_vid_tree(str(tmp_path / "tree"), seed=9, gaps=False)
    exp = tmp_path / "exp"
    cmd = [sys.executable, "-m", "videoyolo_torch.train_yolov3", "--device", "cpu", "--dataset", "vid",
           "--dataset_root", root, "--every", "5", "--batch_size", "2", "--data_shape", str(SIZE),
           "--no_random_shape", "--epochs", "1", "--save_interval", "1", "--nopretrained_cnn", "--dtype", "f32",
           "--num_workers", "2", "--log_interval", "1", "--save_prefix", "0000", "--experiment_root", str(exp),
           *TEMPORAL]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("WORLD_SIZE", None)
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert out.count("samples/sec") >= 2 and "Validation" in out and "mAP=" in out
    ckpt = exp / "0000" / "yolo3_darknet53_vid_0000.params"
    try:
        template = _jax_template(30)
        loaded = jckpt.load_variables(str(ckpt), template)
        leaves = jax.tree_util.tree_leaves(loaded)
        assert len(leaves) == len(jax.tree_util.tree_leaves(template))
        assert all(np.isfinite(np.asarray(a)).all() for a in leaves)
        # the head reads the time-folded routes and both cost volumes (3 x 1024 + 2 x 25 channels)
        assert loaded["params"]["block0"]["_TCell_0"]["ConvBNLeaky_0"]["Conv_0"]["kernel"].shape[2] == 3 * 1024 + 50
    finally:
        shutil.rmtree(exp)  # the full-width model
