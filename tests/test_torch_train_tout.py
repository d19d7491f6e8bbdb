"""The port's YOLOv3Temporal (t=5) training path against the JAX package's,
on the CPU: VID windows with per-frame labels (`mult_out`), a window
epoch's per-frame labels and colour maps, `VOCMApMetricTemporal`, the t_out
train step (per-timestep heads and loss over the correlation pyramid) and
the funnel's train step against `jax.jit(make_train_step)`, checkpoints both
ways, and the train twin with `--temp --mult_out` as a subprocess.

Tolerances: the windows' ids, paths and labels exact, a loader epoch's
labels and colour maps bit for bit at num_workers=1 (pixels within
tests/test_torch_pixels.py's EPOCH_TOL of cv2's), the metric to 1e-12.  The
train steps run in float64 with float64 cost volumes on both sides, as
tests/test_torch_train_temporal.py runs the window step and for its reason
(the packages sum the float32 volumes in different orders, which train-mode
BatchNorm amplifies): losses rtol 1e-6, each updated leaf within 1e-5 of
its largest update, the BN statistics rtol 1e-5 / atol 1e-6."""
import os
import random
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

from test_torch_metrics import NAMES, TOL as METRIC_TOL, _batches
from test_torch_pixels import EPOCH_TOL
from test_torch_train_temporal import PARAMS, STATS, _Float64Jnp, _leaf_errors
from test_torch_vid import write_vid_tree
from videoyolo_tpu.data.imgnetvid import ImageNetVidDetection as JaxVID
from videoyolo_tpu.data.loader import DetectionLoader as JaxLoader
from videoyolo_tpu.data.transforms import YOLO3VideoTrainTransform as JaxVideoTrain
from videoyolo_tpu.metrics.pascalvoc import VOCMApMetricTemporal as JaxTemporalMetric
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.yolo3_temporal import YOLOv3Temporal as JaxYOLOv3Temporal
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.train import lr as jlr
from videoyolo_tpu.train import step as jstep
from videoyolo_torch import train_yolov3
from videoyolo_torch.data.imgnetvid import ImageNetVidDetection
from videoyolo_torch.data.loader import DetectionLoader
from videoyolo_torch.data.transforms import YOLO3VideoInferenceTransform, YOLO3VideoTrainTransform
from videoyolo_torch.metrics.pascalvoc import VOCMApMetricTemporal
from videoyolo_torch.models import layers
from videoyolo_torch.models.yolo3_temporal import YOLOv3Temporal
from videoyolo_torch.train import checkpoint, lr, step
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
T = 5
S, B, C, M = 64, 1, 4, 6
STEPS = 3
LR = dict(mode="step", base_lr=1e-2, steps_per_epoch=10, epochs=3)
MODELS = {"pyramid": dict(t_out=True, corr_d=2), "funnel": dict(t_out=False)}


def _vid(cls, root, **kw):
    return cls(root=os.path.join(root, "ImageNetVID", "ILSVRC"), **kw)


@pytest.fixture(scope="module")
def vid_root(tmp_path_factory):
    """tests/test_torch_vid.py's tree without gaps (the JAX train route
    raises on a frame without a box)."""
    return write_vid_tree(str(tmp_path_factory.mktemp("vidtout")), seed=11, gaps=False)


# --- windows with per-frame labels ----------------------------------------------

@pytest.mark.parametrize("kw", [dict(window=[5, 1]), dict(window=[5, 2], every=3)], ids=["5_1", "5_2_every3"])
def test_mult_out_windows_match_jax(tmp_path_factory, kw):
    """On a tree with gaps: each window's k frame ids (`get_sample_ids`),
    its k paths (`sample_path`) and each frame's label equal JAX's; the
    loader's key frame is the window's middle one."""
    root = write_vid_tree(str(tmp_path_factory.mktemp("gaps")), seed=12)
    kw = dict(kw, splits=[(2017, "val")], mult_out=True, inference=True)
    ours, ref = _vid(ImageNetVidDetection, root, **kw), _vid(JaxVID, root, **kw)
    assert ours.mult_out and ours.get_sample_ids() == ref.get_sample_ids()
    assert all(len(w) == T for w in ours.get_sample_ids())
    loader = DetectionLoader(ours, batch_size=1, native_decode=(S, S))
    for i in range(len(ours)):
        paths = ours.sample_path(i)
        assert paths == ref.sample_path(i) == ours.window_paths(i) and len(paths) == T
        label = ours.label_and_size(i)[0]
        _, ref_label, idx = ref[i]
        assert idx == i and len(label) == len(ref_label) == T
        assert all(np.array_equal(a, b) for a, b in zip(label, ref_label))
        assert loader._key_path(i) == paths[T // 2]
    with pytest.raises(ValueError, match="k > 1"):
        _vid(ImageNetVidDetection, root, splits=[(2017, "val")], mult_out=True)


def _jax_epoch(root, seed):
    np.random.seed(seed)
    random.seed(seed)
    ds = _vid(JaxVID, root, splits=[(2017, "train")], window=[T, 1], mult_out=True)
    loader = JaxLoader(ds, batch_size=2, shuffle=True, last_batch="discard", num_workers=1, seed=seed, max_boxes=8,
                       shape_sizes=[64, 96], shape_interval=1,
                       transform_factory=lambda w, h: JaxVideoTrain(T, w, h, device_color=True))
    return list(loader)


def _port_epoch(root, seed, workers):
    rs, rnd = np.random.RandomState(seed), random.Random(seed)
    ds = _vid(ImageNetVidDetection, root, splits=[(2017, "train")], window=[T, 1], mult_out=True)
    loader = DetectionLoader(ds, batch_size=2, shuffle=True, last_batch="discard", num_workers=workers, seed=seed,
                             max_boxes=8, shape_sizes=[64, 96], shape_interval=1,
                             transform_factory=lambda w, h: YOLO3VideoTrainTransform(T, w, h, rs, rnd))
    return list(loader)


def test_mult_out_window_epoch_matches_jax(vid_root):
    """A shuffled epoch of train windows of 5 with per-frame labels over two
    shape buckets against JAX's per-sample route at num_workers=1: (B, 5,
    S, S, 3) uint8 windows, (B, 5, M, .) boxes, ids and labels and a colour
    map a window bit-equal (one plan a window, applied to every frame's
    boxes), the pixels within the epoch tolerance; 4 workers equal 1."""
    ref = _jax_epoch(vid_root, 3)
    ours = _port_epoch(vid_root, 3, workers=1)
    assert len(ours) == len(ref) > 3 and {b["image"].shape[2] for b in ours} == {64, 96}
    diffs = []
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == {"image", "gt_boxes", "gt_ids", "label", "color"}
        assert a["image"].shape[:2] == (2, T) and a["gt_boxes"].shape == (2, T, 8, 4) and a["color"].shape == (2, 3, 4)
        for key in b:
            if key != "image":
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        diffs.append(np.abs(a["image"].astype(np.float64) - b["image"]).mean())
    assert np.mean(diffs) < EPOCH_TOL, diffs
    # the frames' boxes differ (the objects move) under one plan
    assert any(not np.array_equal(b["gt_boxes"][:, 0], b["gt_boxes"][:, -1]) for b in ours)
    four = _port_epoch(vid_root, 3, workers=4)
    for a, b in zip(ours, four):
        assert all(np.array_equal(a[key], b[key]) for key in a)


def test_mult_out_inference_route(vid_root):
    """The loader's inference route for windows of 5 with per-frame labels:
    (B, 5, S, S, 3) float32 windows and (B, 5, M, .) labels, each frame's
    equal to the video inference transform's."""
    ds = _vid(ImageNetVidDetection, vid_root, splits=[(2017, "val")], window=[T, 1], mult_out=True, inference=True)
    tf = YOLO3VideoInferenceTransform(64, 64)
    batches = list(DetectionLoader(ds, batch_size=4, num_workers=2, inference_transform=tf))
    assert sum(len(b["idx"]) for b in batches) == len(ds) and batches[0]["label"].shape[:2] == (4, T)
    b = batches[1]
    for n, i in enumerate(b["idx"]):
        img, label, _ = ds[int(i)]
        want, boxes, _ = tf(img, label, int(i))
        assert np.array_equal(b["image"][n], want) and len(boxes) == T
        for t, box in enumerate(boxes):
            assert np.array_equal(b["label"][n, t, : len(box), :4], box[:, :4])


# --- the temporal metric --------------------------------------------------------

@pytest.mark.parametrize("names", [None, NAMES], ids=["no_names", "names"])
def test_temporal_metric_matches_jax(names):
    """VOCMApMetricTemporal: one VOC metric a window offset, updated with
    lists over the offsets or one offset at a time; names `t{i}:...` and
    values equal to JAX's to 1e-12."""
    ours, ref = VOCMApMetricTemporal(3, class_names=names), JaxTemporalMetric(3, class_names=names)
    batches = [_batches(seed) for seed in range(3)]  # one stream an offset
    for n in range(len(batches[0])):
        args = [[batches[t][n][j] for t in range(3)] for j in range(6)]
        ours.update(*args)
        ref.update(*args)
    ours.update_t(1, *batches[0][0])
    ref.update_t(1, *batches[0][0])
    (n1, v1), (n2, v2) = ours.get(), ref.get()
    assert n1 == n2 and n1[0].startswith("t0:") and n1[-1].startswith("t2:")
    np.testing.assert_allclose(np.asarray(v1, np.float64), np.asarray(v2, np.float64), rtol=0, atol=METRIC_TOL)
    ours.reset()
    assert all(np.isnan(v) for v in ours.get()[1])


# --- the train steps ---------------------------------------------------------------

def _variables(name):
    model = JaxYOLOv3Temporal(num_classes=C, **MODELS[name])
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.PRNGKey(0),
                            np.zeros((1, T, S, S, 3), np.float32))
    rs = np.random.RandomState(1)

    def fill(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            return (rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if key in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    return model, jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def _batch(per_frame):
    """B uint8 windows of 5 neighbouring frames, one colour map a window
    (powers of two: it rounds nowhere), boxes that move from frame to
    frame: per-timestep gt (B, 5, M, .) with `per_frame`, else the key
    frame's (B, M, .)."""
    rs = np.random.RandomState(2)
    clip = rs.randint(0, 256, (B + T - 1, S, S, 3)).astype(np.uint8)
    gtb = np.full((B, T, M, 4), -1, np.float32)
    gti = np.full((B, T, M, 1), -1, np.float32)
    for t in range(T):
        gtb[0, t, :2] = [[5 + t, 6, 40 + t, 50], [20, 2 + t, 60, 30 + t]]
        gti[0, t, :2, 0] = [1, 3]
    color = np.concatenate([np.eye(3) * 2.0**-6 + np.roll(np.eye(3), 1, 1) * 2.0**-10, np.full((3, 1), -2.0)], -1)
    if not per_frame:
        gtb, gti = gtb[:, T // 2], gti[:, T // 2]
    return {"image": np.stack([clip[i:i + T] for i in range(B)]),
            "color": np.broadcast_to(color, (B, 3, 4)).astype(np.float32), "gt_boxes": gtb, "gt_ids": gti}


def _f64(batch):
    return {key: v.astype(np.float64) if v.dtype.kind == "f" else v for key, v in batch.items()}


def _jax_run(model, v, batch, steps):
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        tx = jstep.make_optimizer(jlr.lr_schedule(**LR))
        state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                                 opt_state=tx.init(v["params"]), tx=tx)
        fn = jax.jit(jstep.make_train_step(model, num_classes=C))
        jb = {key: jnp.asarray(a) for key, a in _f64(batch).items()}
        out = []
        for _ in range(steps):
            state, metrics = fn(state, jb)
            variables = jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
            out.append(({key: t.double() for key, t in flax_to_state_dict(variables).items()},
                        {key: float(m) for key, m in metrics.items()}))
        return out


def _port_model(name, v, dtype=torch.float64):
    model = YOLOv3Temporal(num_classes=C, dtype=dtype, **MODELS[name]).to(dtype)
    model.load_state_dict({key: t.to(dtype) if t.is_floating_point() else t for key, t in flax_to_state_dict(v).items()})
    return model


def _port_run(name, v, batch, steps):
    model = _port_model(name, v)
    state = step.create_train_state(model, lr.lr_schedule(**LR))
    fn = step.make_train_step(model, num_classes=C)
    tb = {key: torch.from_numpy(a) for key, a in _f64(batch).items()}
    out = []
    for _ in range(steps):
        metrics = fn(state, tb)
        out.append(({key: t.detach().double().clone() for key, t in model.state_dict().items()},
                    {key: float(m) for key, m in metrics.items()}))
    return out, model


@pytest.fixture(scope="module")
def runs():
    """{name: (variables, JAX run, (port run, port model))} in float64 with
    float64 cost volumes: the pyramid over 3 steps, the funnel over 1."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "jnp", _Float64Jnp())
        mp.setattr(layers, "CORR_DTYPE", torch.float64)
        for name, steps in (("pyramid", STEPS), ("funnel", 1)):
            model, v = _variables(name)
            batch = _batch(per_frame=name == "pyramid")
            out[name] = (v, _jax_run(model, v, batch, steps), _port_run(name, v, batch, steps))
    return out


def _assert_steps_match(ref, ours, v0, n):
    for (o, om), (r, rm) in zip(ours[:n], ref[:n]):
        assert set(om) == set(rm) == {"obj", "center", "scale", "cls", "total"}
        for key in rm:
            np.testing.assert_allclose(om[key], rm[key], rtol=1e-6, err_msg=key)
    o, r = ours[n - 1][0], ref[n - 1][0]
    worst = max(_leaf_errors(o, r, v0, PARAMS(r)).items(), key=lambda kv: kv[1])
    assert worst[1] < 1e-5, worst
    for key in STATS(r):
        torch.testing.assert_close(o[key], r[key], rtol=1e-5, atol=1e-6)
    return o


@pytest.mark.parametrize("n", [1, STEPS])
def test_t_out_train_step_float64_matches_jax(runs, n):
    """The per-timestep heads and loss over the correlation pyramid (T
    folded into the batch for the targets and the loss): losses, updates
    and BN statistics after 1 and 3 steps; the stage-1 stem learns through
    the cost volumes too."""
    v, ref, (ours, _) = runs["pyramid"]
    v0 = {key: t.double() for key, t in flax_to_state_dict(v).items()}
    o = _assert_steps_match(ref, ours, v0, n)
    for key in ("stage1.conv0.Conv_0.weight", "convs1.Conv_0.weight"):
        assert float((o[key] - v0[key]).abs().max()) > 0, key


def test_funnel_train_step_float64_matches_jax(runs):
    """The funnel (t_out=False: the key frame's gt, one output a window):
    one step, the 3-D cells' BN statistics over B x frames x pixels
    included."""
    v, ref, (ours, _) = runs["funnel"]
    v0 = {key: t.double() for key, t in flax_to_state_dict(v).items()}
    o = _assert_steps_match(ref, ours, v0, 1)
    assert "convs2_t.BatchNorm_0.running_var" in STATS(o)


def test_t_out_eval_step_folds_time(runs):
    """The eval step of a t_out model: per-frame detections (B, 5, 100, .)
    through `postprocess_tout`."""
    _, _, (_, model) = runs["pyramid"]
    ids, scores, boxes = step.make_eval_step(model)(torch.from_numpy(_f64(_batch(True))["image"]).double() / 255)
    assert ids.shape == (B, T, 100, 1) and boxes.shape == (B, T, 100, 4)
    assert step.freeze_base_mask(model)["stage3.ConvBNLeaky_0.Conv_0.weight"]
    assert not step.freeze_base_mask(model)["convs1.Conv_0.weight"]


def test_t5_checkpoints_both_ways(runs, tmp_path):
    """The port's trained YOLOv3Temporal written by `save_params` is read by
    the JAX package against its own template, leaf for leaf; a JAX-written
    file of the funnel (3-D kernels) loads into the port bit for bit."""
    v, _, (_, model) = runs["pyramid"]
    trained = checkpoint.variables_of(model.float())
    checkpoint.save_params(str(tmp_path / "t5"), trained, 0.0, 0.0, epoch=1, save_interval=1)
    path = str(tmp_path / "t5_0001.params")
    read = jax.tree_util.tree_map(np.asarray, jckpt.load_variables(path, jax.tree_util.tree_map(np.zeros_like, v)))
    os.remove(path)
    for (pa, a), (pb, b) in zip(sorted(jax.tree_util.tree_leaves_with_path(read), key=lambda t: str(t[0])),
                                sorted(jax.tree_util.tree_leaves_with_path(trained), key=lambda t: str(t[0]))):
        assert str(pa) == str(pb) and np.array_equal(a, np.asarray(b)), str(pa)
    fv = runs["funnel"][0]
    jpath = str(tmp_path / "jax.params")
    jckpt.save_variables(jpath, fv)
    fresh = checkpoint.load_into(YOLOv3Temporal(num_classes=C, t_out=False), checkpoint.load_variables(jpath))
    os.remove(jpath)
    for key, t in flax_to_state_dict(fv).items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[key], t), key


# --- the train twin --------------------------------------------------------------

def test_pretrained_cnn_raises_on_yolov3_temporal(tmp_path):
    """As the JAX CLI: --pretrained_cnn has no `backbone` scope to load
    into."""
    weights = tmp_path / "darknet53.params"
    weights.write_bytes(b"")
    args = train_yolov3.parse_args(["--dataset", "vid", "--window", "5,1", "--temp", "--mult_out",
                                    "--pretrained_base_path", str(weights)])
    with pytest.raises(RuntimeError, match="YOLOv3Temporal"):
        train_yolov3._load_pretrained_base(args, YOLOv3Temporal(num_classes=2, t_out=True))


def test_train_twin_mult_out_subprocess(vid_root, tmp_path):
    """`python -m videoyolo_torch.train_yolov3 --device cpu --dataset vid
    --window 5,1 --temp --mult_out --corr_pos early --corr_d 2`: one epoch
    at B=2, 64 px, float32, validated with VOCMApMetricTemporal (one mAP a
    window offset); its checkpoint loads into the JAX package's
    YOLOv3Temporal of the same flags (30 classes)."""
    exp = tmp_path / "exp"
    cmd = [sys.executable, "-m", "videoyolo_torch.train_yolov3", "--device", "cpu", "--dataset", "vid",
           "--dataset_root", vid_root, "--every", "5", "--batch_size", "2", "--data_shape", str(S),
           "--no_random_shape", "--epochs", "1", "--save_interval", "1", "--nopretrained_cnn", "--dtype", "f32",
           "--num_workers", "2", "--log_interval", "1", "--save_prefix", "0000", "--experiment_root", str(exp),
           "--window", "5,1", "--temp", "--mult_out", "--corr_pos", "early", "--corr_d", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("WORLD_SIZE", None)
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert out.count("samples/sec") >= 2 and "Validation" in out
    assert all(f"t{t}:mAP=" in out for t in range(T))
    ckpt = exp / "0000" / "yolo3_darknet53_vid_0000.params"
    try:
        jm = JaxYOLOv3Temporal(num_classes=30, t_out=True, corr_d=2)
        shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0),
                                np.zeros((1, T, S, S, 3), np.float32))
        template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        loaded = jckpt.load_variables(str(ckpt), template)
        leaves = jax.tree_util.tree_leaves(loaded)
        assert len(leaves) == len(jax.tree_util.tree_leaves(template))
        assert all(np.isfinite(np.asarray(a)).all() for a in leaves)
        # the pyramid: convs1 reads the 5x5 displacements of the d=2 cost volume
        assert loaded["params"]["convs1"]["Conv_0"]["kernel"].shape == (3, 3, 25, 128)
    finally:
        shutil.rmtree(exp)  # the full-width model
