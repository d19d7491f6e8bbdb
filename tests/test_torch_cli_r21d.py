"""The two entry points with `--motion_stream r21d` (ROADMAP.md Queue 1
item 7, its R(2+1)D half) on an ImageNet-VID tree from disk, against the
JAX package, on the CPU at 64 px:

* the train twin, three steps of the "mul"-gated two-stream model on
  windows of 9, its checkpoint read by JAX (the trained model's raw
  outputs against JAX's apply of it; R(2+1)D's statistics as they were),
  and the detect twin from that checkpoint;
* the detect twin from a JAX-written checkpoint of random weights, its
  cache against JAX's detect step on the same pixels (the JPEG core's)
  within 1e-4, then read by detect_yolo3.py with the same flags, which
  writes the same voc.txt;
* `--pretrained_cnn`: the ImageNet Darknet-53 loaded into the ungated
  model's darknet half as the JAX CLI loads it, R(2+1)D left as it was,
  and the gated model refused beside the JAX CLI's failing load;
* the refusals: a window other than 9 or 33 (JAX's factory assertion),
  `--stream` and `--quantize`; random shapes are the train twin's to take."""
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

from test_torch_backbones import _jax_prediction_maps, _prediction_maps
from test_torch_cli import _jax_env
from test_torch_cli_flownet import _jax_variables
from test_torch_vid import write_vid_tree
from videoyolo_tpu import native as jnative
from videoyolo_tpu.models.factory import YoloConfig as JaxYoloConfig
from videoyolo_tpu.models.factory import build_model as jax_build_model
from videoyolo_tpu.models.yolo3 import postprocess as jax_postprocess
from videoyolo_tpu.models.yolo3 import select_topk_candidates as jax_select
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.utils.gluon_import import load_gluon_darknet53 as jax_load_gluon
from videoyolo_torch import detect, train_yolov3
from videoyolo_torch.models.layers import init_weights
from videoyolo_torch.train.checkpoint import variables_of
from videoyolo_torch.utils.flax_bridge import walk
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SIZE = 64
K = 9
NUM_CLASSES = 30  # ImageNet-VID's
FLAGS = ["--window", f"{K},1", "--motion_stream", "r21d", "--stream_gating", "mul"]
JAX_CFG = dict(k=K, motion_stream="r21d", add_type="mul")


@pytest.fixture(scope="module")
def vid_root(tmp_path_factory):
    return write_vid_tree(str(tmp_path_factory.mktemp("vid_r21d")), seed=29, gaps=False)


def _jax_template(**cfg):
    jm = jax_build_model(JaxYoloConfig(num_classes=NUM_CLASSES, **cfg))
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, cfg["k"], SIZE, SIZE, 3)))
    return jm, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def jax_model():
    """JAX's gated model, its zero template, and its jitted detect step (a
    function a module: one compile a worker)."""
    jm, template = _jax_template(**JAX_CFG)

    @jax.jit
    def step(v, x):
        boxes, scores = jm.apply(v, x, train=False)
        ids, sc, bb = jax_postprocess(boxes, scores, nms_thresh=0.45, nms_topk=400)
        return ids, sc, bb.clip(0, SIZE), jax_select(boxes, scores), boxes, scores

    return jm, template, step


def _detect(vid_root, save_dir, model_path):
    return detect.main(["--dataset", "vid", "--dataset_root", vid_root, "--every", "4", "--data_shape", str(SIZE),
                        "--batch_size", "4", "--device", "cpu", "--model_path", model_path, "--save_dir",
                        str(save_dir), "--save_prefix", "port", "--num_workers", "2", "--metrics", "voc", *FLAGS])


def _check_cache(vid_root, save_dir, preds, step, variables):
    """The detect twin's cache against JAX's detect step on the core's
    pixels of the same windows: ids equal, scores and boxes within 1e-4;
    rows 1e-3 clear of the K-th candidate and of the valid threshold,
    matched as sets.  Returns (the rows matched, the windows' pixels)."""
    dataset = detect.get_dataset(["vid"], vid_root, 4, (K, 1))
    paths = [dataset.sample_path(i) for i in range(len(dataset))]
    cache = detect.load_predictions(str(save_dir / "port"), dataset)
    assert all(cache.get(p, []) == preds[p] for p in paths)
    images = np.stack([jnative.load_batch(dataset.window_paths(i), SIZE, SIZE)[0] for i in range(len(dataset))])
    rids, rsc, rbb, cands, _, _ = (np.asarray(a) for a in step(variables, images))
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
    return matched, images


def test_train_then_detect_twins_match_jax(vid_root, jax_model, tmp_path):
    """`train_yolov3 --motion_stream r21d --stream_gating mul --window 9,1`
    (B=2, 64 px, float32, one epoch of three steps, validated on windows)
    writes a checkpoint that JAX reads, R(2+1)D's running statistics in it
    as the seeded init's; the trained model's prediction maps on the VID val
    windows within 1e-4 of their largest magnitude of JAX's apply of the
    checkpoint; `detect` from the checkpoint caches what JAX's detect step
    gives."""
    jm, template, step = jax_model
    exp = str(tmp_path / "exp")
    try:
        model, stats = train_yolov3.main([
            "--device", "cpu", "--dataset", "vid", "--dataset_root", vid_root, "--every", "4", "--batch_size", "2",
            "--data_shape", str(SIZE), "--no_random_shape", "--epochs", "1", "--save_interval", "1", "--dtype", "f32",
            "--num_workers", "2", "--log_interval", "1", "--save_prefix", "0000", "--experiment_root", exp,
            "--nopretrained_cnn", *FLAGS])
        bb = model.backbone
        assert type(bb).__name__ == "TwoStreamDarknet" and bb.stream == "r21d" and bb.add_type == "mul"
        assert len(stats["epochs"][0]["steps"]) == 3 and stats["val"]
        ckpt = f"{exp}/0000/yolo3_darknet53_vid_0000.params"
        variables = jckpt.load_variables(ckpt, template)
        assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree_util.tree_leaves(variables))
        r21d_stats = dict(walk(variables["batch_stats"]["backbone"]["r21d"]))
        assert all(np.all(a == (1.0 if p[-1] == "var" else 0.0)) for p, a in r21d_stats.items())
        preds = _detect(vid_root, tmp_path / "results", ckpt)
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    _, images = _check_cache(vid_root, tmp_path / "results", preds, step, variables)
    maps = _prediction_maps(model.eval())
    with torch.no_grad():
        model(torch.from_numpy(images))
    ref = jax.jit(lambda v, x: _jax_prediction_maps(jm, v, x, False)[0])(variables, images)
    for i, r in enumerate(ref):
        r = np.asarray(r)
        np.testing.assert_allclose(maps[i].numpy(), r, rtol=0, atol=1e-4 * float(np.abs(r).max()))


def test_detect_twin_cache_matches_jax_step(vid_root, jax_model, tmp_path):
    """The detect twin on VID val windows of 9 from a JAX-written checkpoint
    of random weights: the cache's rows equal JAX's detect step on the
    core's pixels (`_check_cache`); detect_yolo3.py with the same flags
    reads the cache (no model) and writes the same voc.txt."""
    _, template, step = jax_model
    variables = _jax_variables(template, seed=3)
    model_path = str(tmp_path / "jax_model.params")
    save_dir = tmp_path / "results"
    jckpt.save_variables(model_path, variables)
    try:
        preds = _detect(vid_root, save_dir, model_path)
    finally:
        os.remove(model_path)
    matched, _ = _check_cache(vid_root, save_dir, preds, step, variables)
    assert matched > 0
    ours = (save_dir / "port" / "voc.txt").read_text()
    (save_dir / "port" / "voc.txt").unlink()
    r = subprocess.run(
        [sys.executable, "detect_yolo3.py", "--dataset=vid", f"--dataset_root={vid_root}", f"--save_dir={save_dir}",
         "--save_prefix=port", f"--data_shape={SIZE}", "--every=4", "--metrics=voc", f"--window={K},1",
         "--motion_stream=r21d", "--stream_gating=mul"],
        cwd=REPO, env=_jax_env(), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    assert "randomly initialised" not in r.stderr  # the cache was read: no model
    assert (save_dir / "port" / "voc.txt").read_text() == ours


@pytest.fixture(scope="module")
def base_params(tmp_path_factory):
    """A seeded Darknet-53 written as gluoncv's darknet53 `.params`."""
    import chip_smoke

    path = str(tmp_path_factory.mktemp("base") / "darknet53.params")
    chip_smoke.write_darknet53_params(path, seed=6)
    yield path
    os.remove(path)


def _port_model(flags, path):
    args = train_yolov3.parse_args(["--dataset", "vid", "--pretrained_base_path", path, "--data_shape", str(SIZE),
                                    "--no_random_shape", *flags])
    train_yolov3.check_ported(args)
    with torch.device("meta"):
        model = train_yolov3.yolo3_darknet53(["a"] * NUM_CLASSES, **train_yolov3.temporal_kwargs(args))
    return args, init_weights(model.to_empty(device="cpu"), torch.Generator().manual_seed(0))


def test_pretrained_base_beside_jax(base_params):
    """The ungated model: `--pretrained_cnn` loads Darknet-53 into its
    darknet half (`conv0`, `stage1-5`) equal to the JAX CLI's load into the
    same tree, bit for bit, and leaves R(2+1)D as it was.  The gated model
    (`gstart`, `gstage4`): the JAX CLI's load fails with a KeyError, and the
    port's twin refuses it with the reason."""
    _, template = _jax_template(k=K, motion_stream="r21d")
    want = jax_load_gluon(template, base_params, prefix="backbone")["params"]["backbone"]
    args, model = _port_model(FLAGS[:4], base_params)
    motion = {k: t.clone() for k, t in model.backbone.r21d.state_dict().items()}
    train_yolov3._load_pretrained_base(args, model)
    got = variables_of(model)["params"]["backbone"]
    darknet = {p: a for p, a in walk(want) if p[0] != "r21d"}
    assert len(darknet) == 2 * 52 + 52  # the convs' kernels, the BN scales and biases
    for p, a in darknet.items():
        leaf = got
        for key in p:
            leaf = leaf[key]
        assert np.array_equal(leaf, np.asarray(a)), p
    assert all(torch.equal(t, model.backbone.r21d.state_dict()[k]) for k, t in motion.items())

    _, gated = _jax_template(**JAX_CFG)
    assert "gstart" in gated["params"]["backbone"] and "conv0" not in gated["params"]["backbone"]
    with pytest.raises(KeyError):
        jax_load_gluon(gated, base_params, prefix="backbone")
    args, model = _port_model(FLAGS, base_params)
    with pytest.raises(RuntimeError, match="--stream_gating.*either motion stream"):
        train_yolov3._load_pretrained_base(args, model)


def test_refusals_beside_jax():
    """A window other than 9 or 33: JAX's factory asserts when the JAX CLI
    builds the model; the train twin refuses it before loading data and the
    detect twin where its factory builds the model.  `--stream` refuses the
    two-stream backbone and `--quantize` the two-stream model (item 9a).  The train
    twin takes random shapes and --window 33,1 with r21d."""
    with pytest.raises(AssertionError, match=r"k in \{9,33\}"):
        jax_build_model(JaxYoloConfig(num_classes=NUM_CLASSES, k=5, motion_stream="r21d"))
    r5 = ["--window", "5,1", "--motion_stream", "r21d"]
    with pytest.raises(ValueError, match="--window 9,1 or 33,1"):
        train_yolov3.check_ported(train_yolov3.parse_args(["--dataset", "vid", *r5]))
    synthetic = ["--device", "cpu", "--batch_size", "1", "--num_requests", "1", "--data_shape", str(SIZE)]
    with pytest.raises(ValueError, match=r"k in \{9,33\}"):
        detect.main(synthetic + r5)
    with pytest.raises(ValueError, match="built-in per-frame backbone"):
        detect.main(synthetic + FLAGS + ["--stream"])
    with pytest.raises(NotImplementedError, match="item 9a"):
        detect.main(synthetic + FLAGS + ["--quantize", "int8"])
    for window in ("9,1", "33,1"):
        args = train_yolov3.parse_args(["--dataset", "vid", "--window", window, "--motion_stream", "r21d"])
        assert not args.no_random_shape
        train_yolov3.check_ported(args)
