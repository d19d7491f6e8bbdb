"""Slice 4's checkpoints and eval step against the JAX package on the CPU:
the flax msgpack codec both ways (bit for bit, chunked arrays, bfloat16
leaves, numpy scalars), the save / GC / resume policies on the same
directory, a trained model through a file into JAX and back, the eval step
(which reaches K1 on the card) against JAX's, and `python -m
videoyolo_torch.overfit` on the CPU."""
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.test_torch_models import _match_detections, random_variables
from videoyolo_tpu.models.yolo3 import YOLOv3 as JYOLOv3
from videoyolo_tpu.models.yolo3 import select_topk_candidates
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.train import step as jstep
from videoyolo_torch.models.yolo3 import YOLOv3
from videoyolo_torch.train import checkpoint, lr, step
from videoyolo_torch.utils import flax_msgpack
from videoyolo_torch.utils.flax_bridge import walk

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _tree(rs):
    """Variables with every kind of leaf the format carries."""
    return {
        "params": {
            "conv0": {"Conv_0": {"kernel": rs.randn(3, 3, 3, 8).astype(np.float32)},
                      "BatchNorm_0": {"scale": rs.rand(8).astype(np.float32), "bias": np.zeros(8, np.float32)}},
            "big": {"kernel": rs.randn(40, 30).astype(np.float32)},  # chunked below a small MAX_CHUNK_SIZE
            "half": np.asarray(jnp.asarray(rs.randn(5, 3), jnp.bfloat16)),
        },
        "batch_stats": {"conv0": {"BatchNorm_0": {"mean": rs.randn(8).astype(np.float32),
                                                  "var": rs.rand(8).astype(np.float64)}}},
        "step": np.int32(7),
    }


def _as_port(tree):
    """The same tree as the port holds it: a bfloat16 leaf is a torch tensor."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if getattr(tree, "dtype", None) is not None and tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return tree


def _assert_same_tree(ours, ref):
    a, r = dict(walk(ours)), dict(walk(ref))
    assert a.keys() == r.keys()
    for k in r:
        if isinstance(a[k], torch.Tensor):  # bfloat16
            assert a[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(a[k].view(torch.int16).numpy(), np.asarray(r[k]).view(np.int16))
        else:
            assert a[k].dtype == np.asarray(r[k]).dtype and a[k].shape == np.shape(r[k]), k
            np.testing.assert_array_equal(a[k], np.asarray(r[k]))


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 1024)


def test_codec_reads_jax_files(tmp_path, small_chunks):
    tree = _tree(np.random.RandomState(0))
    path = jckpt.save_variables(str(tmp_path / "jax.params"), tree)
    assert b"__msgpack_chunked_array__" in Path(path).read_bytes()
    ours = checkpoint.load_variables(path)
    _assert_same_tree(ours, tree)
    assert isinstance(ours["step"], np.int32) and ours["step"] == 7


def test_codec_writes_files_jax_reads(tmp_path, small_chunks):
    tree = _tree(np.random.RandomState(1))
    ours = checkpoint.save_variables(str(tmp_path / "port.params"), _as_port(tree))
    ref = jckpt.save_variables(str(tmp_path / "jax.params"), tree)
    # the same bytes as flax writes, chunks and all
    assert Path(ours).read_bytes() == Path(ref).read_bytes()
    back = jckpt.load_variables(ours)
    _assert_same_tree(_as_port(back), tree)
    templ = jax.tree_util.tree_map(np.zeros_like, {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    with_template = jckpt.load_variables(ours, templ)
    _assert_same_tree(_as_port(with_template), {k: tree[k] for k in templ})
    assert not list(tmp_path.glob("*.tmp"))  # written through a renamed temporary


def test_codec_msgpack_types():
    """Every msgpack type the reader meets, against flax's own packing."""
    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -2**15 - 1, -2**40],
            "floats": [1.5, -0.0], "none": None, "flags": [True, False], "text": "x" * 40 + "é",
            "long": "y" * 300, "blob": b"\x00\x01" * 200, "wide": {str(i): i for i in range(20)}}
    raw = serialization.msgpack_serialize(tree, in_place=True)
    assert flax_msgpack.to_bytes(tree) == raw
    back = flax_msgpack.from_bytes(raw)
    assert back == serialization.msgpack_restore(raw)


def test_load_detector_params(tmp_path):
    tree = {"params": {"a": {"kernel": np.ones((1, 1, 2, 2), np.float32)}}}
    path = checkpoint.save_variables(str(tmp_path / "x.params"), tree)
    _assert_same_tree(checkpoint.load_detector_params(path, tree), tree)
    with pytest.raises(ValueError, match="does not match the template"):
        checkpoint.load_detector_params(path, {"params": {"a": {"kernel": np.ones((1, 1, 2, 3), np.float32)}}})
    gluon = tmp_path / "gluon.params"
    gluon.write_bytes((0x112).to_bytes(8, "little") + b"\x00" * 16)
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        checkpoint.load_detector_params(str(gluon), tree)


@pytest.mark.parametrize("interval", [2, -3, 0])
def test_save_params_policy_matches_jax(tmp_path, interval):
    tree = {"params": {"a": {"kernel": np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)}}}
    maps = [0.1, 0.3, 0.2, 0.5, 0.5, 0.1, 0.6, 0.2]
    listings, logs, bests = [], [], []
    for save_params, root in ((checkpoint.save_params, tmp_path / "port"), (jckpt.save_params, tmp_path / "jax")):
        root.mkdir()
        best = 0.0
        trail = []
        for epoch, m in enumerate(maps):
            best = save_params(str(root / "yolo3"), tree, m, best, epoch, interval)
            trail.append(best)
        listings.append(sorted(p.name for p in root.iterdir()))
        logs.append((root / "yolo3_best_map.log").read_text())
        bests.append(trail)
    assert listings[0] == listings[1] and logs[0] == logs[1] and bests[0] == bests[1]
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert checkpoint._epoch_of(str(port / "yolo3_0007.params")) == 7
    assert checkpoint._epoch_of(str(port / "yolo3_best.params")) == -1
    latest = checkpoint.find_latest(str(port))
    want = jckpt.find_latest(str(ref))
    assert (latest is None) == (want is None)
    if latest is not None:
        assert os.path.basename(latest) == os.path.basename(want)
    for resume, start in (("", -1), ("", 3), (str(port / "yolo3_best.params"), -1), (str(port / "yolo3_best.params"), 5)):
        got, epoch = checkpoint.resume_params(resume, start, str(port))
        ref_vars, ref_epoch = jckpt.resume_params(resume.replace(str(port), str(ref)), start, str(ref))
        assert epoch == ref_epoch and (got is None) == (ref_vars is None)
        if got is not None:
            _assert_same_tree(got, ref_vars)


def _s2d_models(seed):
    jm = JYOLOv3(num_classes=3, s2d_stem=True)
    x = np.random.RandomState(seed).randn(2, 64, 64, 3).astype(np.float32)
    v = random_variables(jm, x, seed=seed + 1, gain=0.5)
    tm = checkpoint.load_into(YOLOv3(num_classes=3, s2d_stem=True), jax.tree_util.tree_map(np.asarray, v))
    return jm, v, tm, x


def test_eval_step_matches_jax():
    """make_eval_step (eval forward + postprocess_tout, K1's NMS on the
    card) on the s2d-stem YOLOv3 at 64 px, float32, against JAX's."""
    jm, v, tm, x = _s2d_models(30)
    ours = step.make_eval_step(tm)(torch.from_numpy(x))
    ref = jax.jit(jstep.make_eval_step(jm))(v["params"], v["batch_stats"], x)
    cands = np.asarray(select_topk_candidates(*jax.jit(partial(jm.apply, train=False))(v, x)))
    for b in range(2):
        _match_detections([o[b].numpy() for o in ours], [np.asarray(r[b]) for r in ref],
                          max(cands[b, -1, 1], 0.01) + 1e-3)
    assert not tm.training


def test_trained_model_round_trip_through_jax(tmp_path):
    """A model the port trained (two steps, s2d stem) written by
    `save_params` is read by JAX's `load_variables` against its own
    template and by the port, every leaf bit for bit.  (The file holds 61M
    float32 parameters, so it is removed at the end.)"""
    jm, v, tm, x = _s2d_models(32)
    state = step.create_train_state(tm, lr.lr_schedule("constant", 1e-3, steps_per_epoch=1, epochs=1))
    train = step.make_train_step(tm, num_classes=3)
    batch = {"image": torch.from_numpy(x), "gt_boxes": torch.tensor([[[4.0, 4, 40, 50]], [[10, 20, 60, 60]]]),
             "gt_ids": torch.tensor([[[1.0]], [[2.0]]])}
    for _ in range(2):
        train(state, batch)
    trained = checkpoint.variables_of(tm)
    checkpoint.save_params(str(tmp_path / "yolo3"), trained, 0.0, 0.0, epoch=2, save_interval=1)
    path = str(tmp_path / "yolo3_0002.params")
    template = jax.tree_util.tree_map(np.zeros_like, jax.tree_util.tree_map(np.asarray, v))
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, jckpt.load_variables(path, template)), trained)
    fresh = checkpoint.load_into(YOLOv3(num_classes=3, s2d_stem=True), checkpoint.load_variables(path))
    os.remove(path)
    for k, t in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], t), k
    moved = trained["params"]["backbone"]["conv0"]["Conv_0"]["kernel"]
    assert not np.array_equal(moved, np.asarray(v["params"]["backbone"]["conv0"]["Conv_0"]["kernel"]))


def test_overfit_cli_on_cpu(tmp_path):
    """The entry point at 64 px, B=2, 3 steps: it writes its record and its
    checkpoint (3 steps cannot pass the rule, so the exit code is 1)."""
    out, prefix = tmp_path / "rec" / "yolov3.json", tmp_path / "ckpt" / "yolo3"
    proc = subprocess.run(
        [sys.executable, "-m", "videoyolo_torch.overfit", "--device", "cpu", "--data_shape", "64",
         "--batch_size", "2", "--steps", "3", "--out", str(out), "--save_prefix", str(prefix)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 1, proc.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert {"config", "loss_first", "loss_last", "mean_top1_iou", "top1_class_acc", "top1_scores",
            "pass"} <= rec.keys()
    assert rec["pass"] is False and rec["device"] == "cpu" and len(rec["top1_scores"]) == 2
    assert rec["loss_last"] < rec["loss_first"]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == rec
    ckpt = rec["checkpoint"]
    assert ckpt == f"{prefix}_0000.params" and os.path.exists(ckpt)
    jvars = jckpt.load_variables(ckpt)  # the JAX package reads it
    assert set(jvars) == {"params", "batch_stats"}
    model = checkpoint.load_into(YOLOv3(num_classes=3), checkpoint.load_variables(ckpt))
    os.remove(ckpt)  # 61M float32 parameters
    assert model.backbone.conv0.Conv_0.weight.dtype == torch.float32
