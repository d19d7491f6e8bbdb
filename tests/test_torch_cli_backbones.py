"""The two entry points with `--new_model`, `--conv_types`, `--hier` and
`--h_join_type` (ROADMAP.md Queue 1 item 7's `new_model` family) on an
ImageNet-VID tree from disk, against the JAX package, on the CPU at 64 px:

* the train twin with `--pretrained_base_path`: its checkpoint's backbone
  leaves are JAX's inflation of the same Darknet-53 `.params` into
  Darknet3D (the inflate branch of train_yolov3.py:728-763) or JAX's load
  of it into HDarknet (the lr is 0, so the leaves stay as loaded); and with
  `--nopretrained_cnn` as a subprocess, its checkpoint read by JAX;
* the refused `--pretrained_cnn` of an all-2 Darknet3D beside the JAX
  CLI's failing load;
* the detect twin's cache from a JAX-written checkpoint against JAX's
  detect step on the same pixels (the JPEG core's: the JAX CLI's cv2
  pixels differ from them by up to 0.6 after normalising, which moves a
  random model's detections past any row tolerance), then read by
  detect_yolo3.py with the same flags, which writes the same voc.txt;
* the detect twin on YouTube-BB windows, its cache read by
  detect_yolo3.py;
* the synthetic mode, and `--stream --new_model` refused."""
import os
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli import _jax_env
from test_torch_vid import write_vid_tree
from videoyolo_tpu import native as jnative
from videoyolo_tpu.models.darknet import Darknet53 as JaxDarknet53
from videoyolo_tpu.models.factory import YoloConfig as JaxYoloConfig
from videoyolo_tpu.models.factory import build_model as jax_build_model
from videoyolo_tpu.models.inflate import inflate_darknet53_to_3d as jax_inflate
from videoyolo_tpu.models.yolo3 import postprocess as jax_postprocess
from videoyolo_tpu.models.yolo3 import select_topk_candidates as jax_select
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.utils.gluon_import import load_gluon_darknet53 as jax_load_gluon
from videoyolo_torch import detect, train_yolov3
from videoyolo_torch.utils.flax_bridge import walk
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SIZE = 64
NUM_CLASSES = 30  # ImageNet-VID's
MODELS = {  # name: (flags, the JAX factory's keywords, window)
    "darknet3d": (["--window", "5,1", "--new_model", "--conv_types", "2,3,3,2,2,2"],
                  dict(k=5, new_model=True, conv_types=(2, 3, 3, 2, 2, 2)), 5),
    "hdarknet-max": (["--window", "9,1", "--new_model", "--hier", "3,3,1,1,1", "--h_join_type", "max"],
                     dict(k=9, new_model=True, hierarchical=(3, 3, 1, 1, 1), h_join_type="max"), 9),
    "hdarknet-conv": (["--window", "9,1", "--new_model", "--hier", "3,3,1,1,1", "--h_join_type", "conv"],
                      dict(k=9, new_model=True, hierarchical=(3, 3, 1, 1, 1), h_join_type="conv"), 9),
}
# the train twin takes the max merge: from their zero init the conv merges
# zero every feature after them and the first step's gradient overflows in
# both packages (ROADMAP.md Queue 3; tests/test_torch_backbones.py)
TRAINED = ("darknet3d", "hdarknet-max")
DETECTED = ("darknet3d", "hdarknet-conv")


@pytest.fixture(scope="module")
def vid_root(tmp_path_factory):
    return write_vid_tree(str(tmp_path_factory.mktemp("vid_backbones")), seed=21, gaps=False)


@pytest.fixture(scope="module")
def base_params(tmp_path_factory):
    """A seeded Darknet-53 written as gluoncv's darknet53 `.params`."""
    import chip_smoke

    path = str(tmp_path_factory.mktemp("base") / "darknet53.params")
    chip_smoke.write_darknet53_params(path, seed=5)
    yield path
    os.remove(path)


def _jax_template(name):
    _, kw, t = MODELS[name]
    jm = jax_build_model(JaxYoloConfig(num_classes=NUM_CLASSES, **kw))
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, t, SIZE, SIZE, 3)))
    return jm, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _jax_base(name, path):
    """JAX's pretrained base for `name`: Darknet-53 from the `.params`
    inflated into Darknet3D's tree, or loaded into HDarknet's."""
    jm, template = _jax_template(name)
    if name.startswith("hdarknet"):
        return jax_load_gluon(template, path, prefix="backbone")["params"]["backbone"]
    v2 = JaxDarknet53().init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), False)
    v2 = jax_load_gluon(dict(v2), path, prefix="")
    sub = jax_inflate(v2, {"params": template["params"]["backbone"],
                           "batch_stats": template["batch_stats"]["backbone"]}, MODELS[name][1]["conv_types"])
    return sub["params"]


def _train_flags(root, exp, extra):
    return ["--device", "cpu", "--dataset", "vid", "--dataset_root", root, "--every", "5", "--batch_size", "2",
            "--data_shape", str(SIZE), "--no_random_shape", "--epochs", "1", "--save_interval", "1", "--dtype",
            "f32", "--num_workers", "2", "--log_interval", "1", "--save_prefix", "0000", "--experiment_root", exp,
            *extra]


@pytest.mark.parametrize("name", TRAINED)
def test_train_twin_pretrained_base_matches_jax(name, vid_root, base_params, tmp_path):
    """`--pretrained_base_path` through the train twin (one epoch at lr 0,
    B=2 windows): the checkpoint's backbone parameters equal JAX's inflate
    (Darknet3D) or load (HDarknet) of the same `.params` bit for bit, and
    JAX reads the checkpoint."""
    exp = str(tmp_path / "exp")
    model, stats = train_yolov3.main(_train_flags(vid_root, exp, MODELS[name][0] + [
        "--pretrained_base_path", base_params, "--lr", "0"]))
    try:
        assert model.has_backbone and type(model.backbone).__name__ == {"darknet3d": "Darknet3D",
                                                                        "hdarknet-max": "HDarknet"}[name]
        assert len(stats["epochs"][0]["steps"]) >= 2 and stats["val"]
        _, template = _jax_template(name)
        ckpt = jckpt.load_variables(f"{exp}/0000/yolo3_darknet53_vid_0000.params", template)
        got = dict(walk(ckpt["params"]["backbone"]))
        want = dict(walk(_jax_base(name, base_params)))
        assert got.keys() == want.keys()
        for p, a in want.items():
            assert np.array_equal(np.asarray(got[p]), np.asarray(a)), p
        if name == "darknet3d":
            stem = np.asarray(got[("down0", "ConvBNLeaky3D_0", "Conv_0", "kernel")])
            np.testing.assert_array_equal(stem[0], stem[2])  # the 2D kernel over time, / 3
    finally:
        shutil.rmtree(exp)


def test_train_twin_nopretrained_subprocess(vid_root, tmp_path):
    """`python -m videoyolo_torch.train_yolov3 --new_model --conv_types
    2,21,21,2,2,2 --window 5,1 --nopretrained_cnn`: one epoch, validated on
    windows; JAX's Darknet3D YOLOv3T of the same flags reads the
    checkpoint, its 2+1D cells' temporal kernels included."""
    exp = str(tmp_path / "exp")
    cmd = [sys.executable, "-m", "videoyolo_torch.train_yolov3", *_train_flags(vid_root, exp, [
        "--window", "5,1", "--new_model", "--conv_types", "2,21,21,2,2,2", "--nopretrained_cnn"])]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("WORLD_SIZE", None)
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert out.count("samples/sec") >= 2 and "Validation" in out and "mAP=" in out
    try:
        jm = jax_build_model(JaxYoloConfig(num_classes=NUM_CLASSES, k=5, new_model=True,
                                           conv_types=(2, 21, 21, 2, 2, 2)))
        shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0),
                                jnp.zeros((1, 5, SIZE, SIZE, 3)))
        template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        loaded = jckpt.load_variables(f"{exp}/0000/yolo3_darknet53_vid_0000.params", template)
        assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree_util.tree_leaves(loaded))
        temporal = loaded["params"]["backbone"]["down0"]["Conv21DRepPad_0"]["temporal"]["kernel"]
        assert temporal.shape == (3, 1, 1, 1, 64)
    finally:
        shutil.rmtree(exp)


def test_pretrained_all_2d_darknet3d_refused_beside_jax_failure(base_params):
    """With every conv type 2 the JAX CLI loads Darknet-53's paths into
    Darknet3D's tree (train_yolov3.py:765), whose names differ, and fails;
    the port's twin refuses the case with an error that says why, as it
    refuses --conv_types with --hier (the JAX CLI's inflate fails on
    HDarknet's tree)."""
    jm = jax_build_model(JaxYoloConfig(num_classes=NUM_CLASSES, k=5, new_model=True))
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 5, SIZE, SIZE, 3)))
    assert "stem" in shapes["params"]["backbone"] and "conv0" not in shapes["params"]["backbone"]
    with pytest.raises(KeyError):
        jax_load_gluon(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), base_params,
                       prefix="backbone")
    for extra, match in ((["--window", "5,1", "--new_model"], "every conv type 2"),
                         (["--window", "9,1", "--new_model", "--hier", "3,3,1,1,1", "--conv_types", "2,3,3,2,2,2"],
                          "inflate into Darknet3D only")):
        args = train_yolov3.parse_args(["--pretrained_base_path", base_params, *extra])
        model = train_yolov3.yolo3_darknet53(["a"] * NUM_CLASSES, **train_yolov3.temporal_kwargs(args))
        with pytest.raises(RuntimeError, match=match):
            train_yolov3._load_pretrained_base(args, model)


def _jax_variables(name, seed):
    """Random variables of JAX's model at lecun scale (a smaller gain fades
    the deep features into their BN biases, the same at every interior
    cell, and the tied scores leave the NMS's order to each package's
    top-k)."""
    _, template = _jax_template(name)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            return (rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if key in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


@pytest.mark.parametrize("name", DETECTED)
def test_detect_twin_cache_matches_jax_step(name, vid_root, tmp_path):
    """The detect twin on VID val windows from a JAX-written checkpoint: the
    cache's rows equal JAX's detect step on the core's pixels of the same
    windows (ids equal, scores and boxes within 1e-4; rows 1e-3 clear of
    the K-th candidate and of the valid threshold, matched as sets);
    detect_yolo3.py with the same flags reads the cache (no model) and
    writes the same voc.txt."""
    flags, _, _ = MODELS[name]
    variables = _jax_variables(name, seed=3)
    model_path = str(tmp_path / "jax_model.params")
    jckpt.save_variables(model_path, variables)
    save_dir = tmp_path / "results"
    argv = ["--dataset", "vid", "--dataset_root", vid_root, "--every", "4", "--data_shape", str(SIZE),
            "--batch_size", "4", "--device", "cpu", "--model_path", model_path, "--save_dir", str(save_dir),
            "--save_prefix", "port", "--num_workers", "2", "--metrics", "voc", *flags]
    try:
        preds = detect.main(argv)
    finally:
        os.remove(model_path)
    window = tuple(int(w) for w in flags[1].split(","))
    dataset = detect.get_dataset(["vid"], vid_root, 4, window)
    paths = [dataset.sample_path(i) for i in range(len(dataset))]
    cache = detect.load_predictions(str(save_dir / "port"), dataset)
    assert all(cache.get(p, []) == preds[p] for p in paths)

    images = np.stack([jnative.load_batch(dataset.window_paths(i), SIZE, SIZE)[0] for i in range(len(dataset))])
    jm, _ = _jax_template(name)

    @jax.jit
    def step(v, x):
        boxes, scores = jm.apply(v, x, train=False)
        ids, sc, bb = jax_postprocess(boxes, scores, nms_thresh=0.45, nms_topk=400)
        return ids, sc, bb.clip(0, SIZE), jax_select(boxes, scores)

    rids, rsc, rbb, cands = (np.asarray(a) for a in step(variables, images))
    matched = 0
    for i, p in enumerate(paths):
        floor = max(cands[i, -1, 1], 0.01) + 1e-3
        want = [(int(c), np.concatenate([[s], b / SIZE])) for c, s, b in zip(rids[i, :, 0], rsc[i, :, 0], rbb[i])
                if c >= 0 and s >= floor]
        got = [(e[0], np.asarray(e[1:])) for e in cache.get(p, []) if e[1] >= floor]
        assert len(got) == len(want), p
        unused = list(range(len(want)))
        for c, row in got:
            hit = next(u for u in unused if want[u][0] == c and np.abs(want[u][1] - row).max() < 1e-4)
            unused.remove(hit)
            matched += 1
    assert matched > 0

    ours = (save_dir / "port" / "voc.txt").read_text()
    (save_dir / "port" / "voc.txt").unlink()
    jflags = [a if a == "--new_model" else f"{a}={b}" for a, b in zip(flags, flags[1:] + [""])
              if a.startswith("--")]  # absl's --flag=value
    r = subprocess.run(
        [sys.executable, "detect_yolo3.py", "--dataset=vid", f"--dataset_root={vid_root}", f"--save_dir={save_dir}",
         "--save_prefix=port", f"--data_shape={SIZE}", "--every=4", "--metrics=voc", *jflags],
        cwd=REPO, env=_jax_env(), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    assert "randomly initialised" not in r.stderr  # the cache was read: no model
    assert (save_dir / "port" / "voc.txt").read_text() == ours


def test_detect_twin_on_yt_windows_read_by_jax(tmp_path):
    """YouTube-BB val windows of 5 frames through the 2+1D Darknet3D
    (seeded random weights): the key frames' detections cached, and
    detect_yolo3.py with the same flags reads the cache (no model) and
    writes the same voc.txt."""
    from test_torch_youtubebb import write_yt_tree

    root = write_yt_tree(str(tmp_path / "tree"), seed=12, splits=(("train", 2, 5), ("validation", 3, 4)),
                         absent=0.2, start=lambda c: 100 * c)
    flags = ["--window", "5,1", "--new_model", "--conv_types", "2,21,21,2,2,2"]
    save_dir = tmp_path / "results"
    preds = detect.main(["--dataset", "yt", "--dataset_root", root, "--data_shape", str(SIZE), "--batch_size", "4",
                         "--device", "cpu", "--save_dir", str(save_dir), "--save_prefix", "port", "--num_workers",
                         "2", "--metrics", "voc", *flags])
    assert len(preds) == len(detect.get_dataset(["yt"], root, window=(5, 1))) > 0
    assert sum(len(v) for v in preds.values()) > 0 and all(p.endswith(".jpg") for p in preds)
    ours = (save_dir / "port" / "voc.txt").read_text()
    (save_dir / "port" / "voc.txt").unlink()
    r = subprocess.run(
        [sys.executable, "detect_yolo3.py", "--dataset=yt", f"--dataset_root={root}", f"--save_dir={save_dir}",
         "--save_prefix=port", f"--data_shape={SIZE}", "--metrics=voc", "--window=5,1", "--new_model",
         "--conv_types=2,21,21,2,2,2"],
        cwd=REPO, env=_jax_env(), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    assert "randomly initialised" not in r.stderr  # the cache was read: no model
    assert (save_dir / "port" / "voc.txt").read_text() == ours


@pytest.mark.parametrize("flags", [
    ["--window", "5,1", "--new_model", "--conv_types", "2,21,21,2,2,2"],
    ["--window", "9,1", "--new_model", "--hier", "3,3,1,1,1", "--h_join_type", "max"],
], ids=["darknet3d", "hdarknet"])
def test_detect_twin_synthetic_new_model(flags):
    """The synthetic mode with --new_model: seeded windows through Darknet3D
    and HDarknet, one set of detections a window; --stream refuses the
    backbone, as the JAX package's stream asserts
    (tests/test_torch_backbones.py holds that assert)."""
    base = ["--device", "cpu", "--data_shape", str(SIZE), "--batch_size", "1", "--num_requests", "2", "--seed", "4"]
    preds = detect.main(base + flags)
    assert sorted(preds) == ["request0/window0000", "request1/window0000"]
    with pytest.raises(ValueError, match="built-in per-frame backbone"):
        detect.main(base + flags + ["--stream"])
    with pytest.raises(ValueError, match="built-in per-frame backbone"):
        detect.main(base + flags + ["--stream", "--dataset", "vid", "--dataset_root", "nowhere"])
