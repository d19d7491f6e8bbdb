"""The port's detect step (`serving.Detector`) and entry point against the
JAX package's on the CPU, and the guards: the port imports no JAX, and its
entry points never move to the CPU on their own."""
import json
import os
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from videoyolo_tpu.data.transforms import to_normalized as jax_to_normalized
from videoyolo_tpu.models.s2d import pad_stem_cin as jax_pad_stem_cin
from videoyolo_tpu.models.yolo3 import YOLOv3 as JaxYOLOv3
from videoyolo_tpu.models.yolo3 import postprocess as jax_postprocess
from videoyolo_tpu.models.yolo3 import select_topk_candidates as jax_select
from videoyolo_torch import detect
from videoyolo_torch.device import resolve_device
from videoyolo_torch.models.factory import YoloConfig
from videoyolo_torch.serving import Detector, collect_boxes
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SIZE = 64


def _standard_variables(seed):
    """Random variables of the standard (3-channel stem) YOLOv3, the layout
    checkpoints are stored in; kernel gain 0.5 keeps activations in range."""
    model = JaxYOLOv3(num_classes=20)
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rs.randn(*shape).astype(np.float32) * 0.5 / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _images(seed, b=2):
    return np.random.RandomState(seed).randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8)


def test_detector_matches_jax_detect_step():
    """Full-width YOLOv3(20, pad_stem) in float32, standard checkpoint
    refolded on load, uint8 images normalised on the device: the JAX detect
    step's detections (detect_yolo3.py:494-502), compared as sets for rows
    scored 1e-3 clear of the K-th candidate and of the valid threshold."""
    variables = _standard_variables(0)
    images = _images(1)
    det = Detector(YoloConfig(num_classes=20, pad_stem=True), variables, data_shape=SIZE, device="cpu")
    ids, sc, bb = (a.numpy() for a in det(images))

    jm = JaxYOLOv3(num_classes=20, pad_stem=True)
    jv = jax_pad_stem_cin(variables, prefix="backbone")

    @jax.jit
    def step(x):
        boxes, scores = jm.apply(jv, x, train=False)
        ids, sc, bb = jax_postprocess(boxes, scores, nms_thresh=0.45, nms_topk=400)
        return ids, sc, bb.clip(0, SIZE), jax_select(boxes, scores)

    rids, rsc, rbb, cands = (np.asarray(a) for a in step(jax_to_normalized(images)))
    assert ids.shape == rids.shape == (2, 100, 1) and bb.shape == (2, 100, 4)
    assert bb.min() >= 0 and bb.max() <= SIZE
    for b in range(2):
        floor = max(cands[b, -1, 1], 0.01) + 1e-3
        pick = lambda i, s, x: [  # noqa: E731
            (int(c), np.concatenate([[p], q])) for c, p, q in zip(i.ravel(), s.ravel(), x)
            if c >= 0 and p >= floor
        ]
        ours, ref = pick(ids[b], sc[b], bb[b]), pick(rids[b], rsc[b], rbb[b])
        assert len(ours) == len(ref) > 0
        unused = list(range(len(ref)))
        for c, row in ours:
            hit = next(u for u in unused if ref[u][0] == c and np.abs(ref[u][1] - row).max() < 1e-3)
            unused.remove(hit)


def test_detector_random_init_is_seeded_and_padded():
    cfg = YoloConfig(num_classes=20, pad_stem=True)
    images = _images(2)
    a = Detector(cfg, data_shape=SIZE, device="cpu", seed=3)
    ids, sc, bb = a(images)
    ids2, sc2, bb2 = Detector(cfg, data_shape=SIZE, device="cpu", seed=3)(images)
    assert torch.equal(ids, ids2) and torch.equal(sc, sc2) and torch.equal(bb, bb2)
    assert not torch.equal(sc, Detector(cfg, data_shape=SIZE, device="cpu", seed=4)(images)[1])
    assert ids.shape == sc.shape == (2, 100, 1) and bb.shape == (2, 100, 4)
    assert ((ids >= -1) & (ids < 20)).all() and ((sc == -1) | ((sc > 0.01) & (sc <= 1))).all()
    assert bb.min() >= 0 and bb.max() <= SIZE
    pad = ids[..., 0] < 0
    assert (bb[pad] == 0).all()  # -1 padding boxes clip to 0
    # float input is taken as already normalised
    normed = jax_to_normalized(images)
    for x, y in zip(a(normed), (ids, sc, bb)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="expected images"):
        a(images[:, :32])


def test_detector_bf16_on_cpu():
    det = Detector(
        YoloConfig(num_classes=20, pad_stem=True), dtype=torch.bfloat16, data_shape=SIZE, device="cpu"
    )
    conv0 = det.model.backbone.conv0.Conv_0
    assert conv0.weight.dtype == torch.float32 and conv0.dtype == torch.bfloat16  # float32 masters
    ids, sc, bb = det(_images(5, b=1))
    assert sc.dtype == torch.float32 and torch.isfinite(bb).all() and (ids >= 0).sum() > 0


def test_collect_boxes_matches_cli():
    # imported here: the CLI registers absl flags, process-wide
    from detect_yolo3 import _collect_boxes as jax_collect_boxes

    rs = np.random.RandomState(6)
    ids = rs.randint(-1, 3, (10, 1)).astype(np.float32)
    sc = rs.rand(10, 1).astype(np.float32)
    bb = rs.rand(10, 4).astype(np.float32) * SIZE
    ours, ref = {}, {}
    collect_boxes(ours, "a.jpg", ids, sc, bb, SIZE)
    jax_collect_boxes(ref, "a.jpg", ids, sc, bb, SIZE)
    assert ours == ref and len(ours["a.jpg"]) == (ids >= 0).sum()


def test_detect_entry_point_on_cpu(tmp_path, capsys):
    out = tmp_path / "preds.json"
    preds = detect.main([
        "--data_shape", str(SIZE), "--batch_size", "2", "--num_requests", "2",
        "--device", "cpu", "--dtype", "f32", "--out", str(out),
    ])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("request")]
    assert len(lines) == 2 and "on cpu" in lines[0]
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(preds)) and len(saved) == 4
    for entries in saved.values():
        assert all(len(e) == 6 and 0 <= min(e[2:]) and max(e[2:]) <= 1 for e in entries)


def test_detect_defaults_to_float32():
    """The entry point serves float32 unless asked, as detect_yolo3.py
    builds its model (YoloConfig.dtype unset); bf16 is an opt-in."""
    assert detect.DTYPES[detect.parse_args([]).dtype] == torch.float32
    assert detect.DTYPES[detect.parse_args(["--dtype", "bf16"]).dtype] == torch.bfloat16


def test_no_cpu_drift_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Detector(YoloConfig(num_classes=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect.main(["--data_shape", str(SIZE), "--batch_size", "1", "--num_requests", "1"])


def test_import_leaves_jax_out():
    """Importing every module of the port, its entry points and the kernel
    wrappers (with no nvcc on PATH) loads no jax, flax, videoyolo_tpu, cv2
    or PIL; MobileNet, the class surgery, the extract twin and the modules
    the int8 dynamic and static modes changed among them.
    A subprocess: this test process imported jax already."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import videoyolo_torch, videoyolo_torch.detect, videoyolo_torch.ops.nms_kernel\n"
        "import videoyolo_torch.ops.correlation_kernel\n"
        "for m in pkgutil.walk_packages(videoyolo_torch.__path__, 'videoyolo_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'videoyolo_tpu', 'cv2', 'PIL')]\n"
        "new = ('videoyolo_torch.models.mobilenet', 'videoyolo_torch.models.surgery',\n"
        "       'videoyolo_torch.extract_base_features', 'videoyolo_torch.ops.quantize',\n"
        "       'videoyolo_torch.ops.int8_conv', 'videoyolo_torch.ops.int8_conv_kernel',\n"
        "       'videoyolo_torch.models.layers', 'videoyolo_torch.models.darknet',\n"
        "       'videoyolo_torch.models.yolo3', 'videoyolo_torch.models.yolo3_temporal',\n"
        "       'videoyolo_torch.serving', 'videoyolo_torch.streaming', 'videoyolo_torch.utils.flax_bridge')\n"
        "bad += [m for m in new if m not in sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith('videoyolo_torch')]), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PATH", "PYTHONPATH")}
    env["PATH"] = ""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(maxsplit=1)
    assert int(n) >= 15 and bad.strip() == "[]", proc.stdout


def test_sources_import_no_jax():
    # nor cv2 or PIL, which the card's machine lacks
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|msgpack|videoyolo_tpu|cv2|PIL)\b", re.M)
    sources = sorted((REPO / "videoyolo_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) >= 25
    for path in sources:
        hits = pattern.findall(path.read_text())
        assert not hits, (path, hits)
