"""The port's int8 dynamic and static modes on YOLOv3 (ROADMAP.md item 9a)
against the JAX package, on the CPU: the calibrated `xscale` tree, every
int8 cell's quantised input and output, the prediction maps and the
detections of YOLOv3 and of the head-only YOLOv3, `Detector` with each
`quantize`, and both paths of the detect twin (the dataset path's
`--quantize`, which it used to ignore, included).

Inputs and weights are made with numpy from a seed and handed to both
packages; the JAX package runs under jit, as its CLI and
`calibrate_detector_variables` run it.  The int8 inputs of the cells (each
conv's int8 operand, recorded in call order on both sides) are compared bit
for bit, the cells' float32 outputs within rtol = atol = 1e-6, the
prediction maps within 1e-5 and the detections' ids exactly, their boxes
and scores within 1e-4."""
import itertools
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import write_voc_tree
from test_torch_int8 import float_variables
from videoyolo_tpu.data.transforms import to_normalized as jax_to_normalized
from videoyolo_tpu.models.yolo3 import YOLOv3 as JaxYOLOv3
from videoyolo_tpu.models.yolo3 import postprocess as jax_postprocess
from videoyolo_tpu.ops import quantize as jquantize
from videoyolo_torch import detect
from videoyolo_torch.models import layers
from videoyolo_torch.models.factory import YoloConfig
from videoyolo_torch.models.yolo3 import YOLOv3
from videoyolo_torch.ops import quantize
from videoyolo_torch.serving import Detector
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

SIZE = 64
NC = 3
CELL_TOL = dict(rtol=1e-6, atol=1e-6)
MAP_TOL = dict(rtol=1e-5, atol=1e-5)
DET_TOL = dict(rtol=1e-4, atol=1e-4)
MODES = {"static": "static", "dynamic": True}


# --- the helpers both files use ---------------------------------------------

def _intermediates(tree, path=()):
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            out[".".join(path)] = v[0]
        else:
            out.update(_intermediates(v, path + (k,)))
    return out


def _int8_cell(module, method_name):
    """The modules whose outputs `jax_apply` keeps: the int8 cells."""
    return method_name == "__call__" and type(module).__name__ in ("ConvBNLeaky", "ConvBNLeaky3D") \
        and bool(getattr(module, "quant", None))


def jax_apply(model, variables, x):
    """`model.apply` under jit -> (outputs, {module path: output}, [the int8
    operand of every int8 conv, in call order], the sown calibration tree).
    The operands are read by wrapping `jax.lax.conv_general_dilated` while
    jit traces (int8 left operands only: the float convs pass through)."""
    def run(v, xx):
        qs = []
        orig = jax.lax.conv_general_dilated

        def record(lhs, *a, **k):
            if lhs.dtype == jnp.int8:
                qs.append(lhs)
            return orig(lhs, *a, **k)

        jax.lax.conv_general_dilated = record
        try:
            out, state = model.apply(v, xx, train=False, capture_intermediates=_int8_cell,
                                     mutable=["intermediates", "quant_calib"])
        finally:
            jax.lax.conv_general_dilated = orig
        return out, state["intermediates"], qs, state.get("quant_calib", {})

    out, inter, qs, calib = jax.tree_util.tree_map(np.asarray, jax.jit(run)(variables, x))
    return out, _intermediates(inter), qs, calib


def port_apply(model, x):
    """The port's forward -> (outputs, {int8 cell path: output NHWC}, [the
    int8 operand of every int8 conv NHWC, in call order])."""
    qs, outs = [], {}
    conv2d, conv3d = layers.int8_conv, layers.int8_conv3d

    def rec2(q, *a, **k):
        qs.append(q.permute(0, 2, 3, 1).numpy())
        return conv2d(q, *a, **k)

    def rec3(q, *a, **k):
        qs.append(q.numpy())
        return conv3d(q, *a, **k)

    def keep(name, out):
        out = out.q if isinstance(out, layers.QTensor) else out
        out = out.permute(0, 2, 3, 1) if out.dim() == 4 else out
        outs[name] = out.numpy() if out.dtype == torch.int8 else out.float().numpy()

    hooks = [m.register_forward_hook(lambda mod, i, o, n=n: keep(n, o))
             for n, m in model.named_modules()
             if isinstance(m, (layers.ConvBNLeaky, layers.ConvBNLeaky3D)) and m.quant]
    layers.int8_conv, layers.int8_conv3d = rec2, rec3
    try:
        with torch.inference_mode():
            out = model(x)
    finally:
        layers.int8_conv, layers.int8_conv3d = conv2d, conv3d
        for h in hooks:
            h.remove()
    return out, outs, qs


def assert_same_tree(ours, ref):
    """Two variable trees with the same paths, dtypes and shapes and equal
    leaves, bit for bit."""
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_ours] == [jax.tree_util.keystr(p) for p, _ in flat_ref]
    for (p, a), (_, b) in zip(flat_ours, flat_ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


def leaf_names(tree):
    return {jax.tree_util.keystr(p).split("'")[-2] for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_cells_match(port_outs, port_qs, jax_inter, jax_qs, n_cells):
    """Every int8 operand bit for bit, every int8 cell's output within
    CELL_TOL of the JAX cell's."""
    assert len(port_qs) == len(jax_qs) == n_cells
    for i, (a, b) in enumerate(zip(port_qs, jax_qs)):
        assert a.dtype == b.dtype == np.int8 and a.shape == b.shape, (i, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"int8 operand {i}")
    assert len(port_outs) == n_cells and all(n in jax_inter for n in port_outs)
    for name, o in port_outs.items():
        ref = np.asarray(jax_inter[name], np.float32)
        assert o.shape == ref.shape, name
        np.testing.assert_allclose(o, ref, err_msg=name, **CELL_TOL)


def assert_calib_matches(model, jax_calib):
    """The amax every dynamic cell recorded equals the value JAX sowed."""
    ours = quantize._calibration_tree(model)
    flat = jax.tree_util.tree_flatten_with_path(jax_calib)[0]
    assert len(flat) == sum(1 for _ in jax.tree_util.tree_flatten(ours)[0])
    for path, v in flat:
        node = ours
        for k in path[:-2] if isinstance(path[-1], jax.tree_util.SequenceKey) else path[:-1]:
            node = node[k.key]
        assert node["amax"] == np.float32(v), jax.tree_util.keystr(path)


def detections(boxes, scores, size):
    ids, sc, bb = jax_postprocess(jnp.asarray(boxes), jnp.asarray(scores), nms_thresh=0.45, nms_topk=400)
    return np.asarray(ids), np.asarray(sc), np.asarray(bb).clip(0, size)


def assert_detections_match(got, want):
    ids, sc, bb = (np.asarray(a) for a in got)
    rids, rsc, rbb = want
    assert ids.shape == rids.shape and (ids >= 0).sum() > 0
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_allclose(sc, rsc, **DET_TOL)
    np.testing.assert_allclose(bb, rbb, **DET_TOL)


def random_variables(model, seed):
    """Random float32 variables in the JAX package's layout, the tree of the
    port's float `model` through the bridge (the flax tree, which the JAX
    model applies strict; cheaper than tracing its init): kernels N(0,
    1/fan_in), those under a `prediction` module (the output convs and
    conv-RNNs) 0.1 of it, BN scale and variance in [0.5, 1.5], the rest
    N(0, 0.01)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            gain = 0.1 if any(getattr(p, "key", None) == "prediction" for p in path) else 1.0
            return rng.standard_normal(shape, dtype=np.float32) * np.float32(gain / np.sqrt(np.prod(shape[:-1])))
        if name in ("scale", "var"):
            return rng.random(shape, dtype=np.float32) + np.float32(0.5)
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.1)

    return jax.tree_util.tree_map_with_path(fill, state_dict_to_flax(model.state_dict()))


def load(model, qvars):
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, qvars)), strict=True)
    return model.eval().to(memory_format=torch.channels_last)


# --- YOLOv3 ------------------------------------------------------------------

@pytest.fixture(scope="module")
def yolo_jax():
    """JAX YOLOv3(3 classes, pad_stem) in float32 at 64 px: float variables,
    two calibration batches of two images, `quantize_static` over both, and
    under jit the static and the dynamic model on the first batch."""
    model = JaxYOLOv3(num_classes=NC, pad_stem=True)
    rs = np.random.RandomState(11)
    images = [rs.randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8) for _ in range(2)]
    xs = [np.asarray(jax_to_normalized(im)) for im in images]
    variables = random_variables(YOLOv3(num_classes=NC, pad_stem=True), 12)
    smodel, svars = jquantize.quantize_static(model, variables, [jnp.asarray(x) for x in xs])
    dvars = jquantize.quantize_detector_variables(variables)
    runs = {"static": jax_apply(smodel, svars, xs[0]),
            "dynamic": jax_apply(jquantize.replace_quant(model, True), dvars, xs[0])}
    qvars = {"static": jax.tree_util.tree_map(np.asarray, svars),
             "dynamic": jax.tree_util.tree_map(np.asarray, dvars)}
    return dict(variables=variables, images=images, xs=xs, qvars=qvars, runs=runs)


def test_quantize_static_matches_jax(yolo_jax):
    """The port's `quantize_static` on the bridged float weights and the
    same two batches gives JAX's variables: the qkernels, the folded
    scales and biases, and every cell's `xscale` (the max over both batches
    of the amax it saw, over 127 in numpy) bit for bit."""
    fm = YOLOv3(num_classes=NC, pad_stem=True)
    fm.load_state_dict(flax_to_state_dict(yolo_jax["variables"]), strict=True)
    qm, ours = quantize.quantize_static(fm.eval(), state_dict_to_flax(fm.state_dict()),
                                         [torch.from_numpy(x) for x in yolo_jax["xs"]])
    assert qm.init_kwargs["quant"] == "static" and not qm.training
    assert "xscale" in leaf_names(ours) and "oscale" not in leaf_names(ours)
    assert_same_tree(ours, yolo_jax["qvars"]["static"])
    # the first batch alone calibrates other scales: the max spans both
    one = quantize.calibrate_detector_variables(
        quantize.replace_quant(fm, True), quantize.quantize_detector_variables(state_dict_to_flax(fm.state_dict())),
        [torch.from_numpy(yolo_jax["xs"][0])])
    xs_one = [np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(one)[0] if "xscale" in str(p)]
    xs_two = [np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(ours)[0] if "xscale" in str(p)]
    assert len(xs_one) == len(xs_two) == 72
    assert all(a <= b for a, b in zip(xs_one, xs_two)) and any(a < b for a, b in zip(xs_one, xs_two))


@pytest.mark.parametrize("mode", list(MODES))
def test_yolov3_int8_matches_jax(yolo_jax, mode):
    """JAX's int8 variables, bridged, through the port's YOLOv3(quant=...):
    the 72 int8 operands bit for bit, every cell's output, the prediction
    maps, the detections; the dynamic cells record the amax JAX sows while
    `layers.calibrating`, and nothing when served outside it."""
    (jboxes, jscores), inter, jqs, jcalib = yolo_jax["runs"][mode]
    model = load(YOLOv3(num_classes=NC, pad_stem=True, quant=MODES[mode]), yolo_jax["qvars"][mode])
    x = torch.from_numpy(yolo_jax["xs"][0])
    if mode == "dynamic":
        with torch.inference_mode():
            model(x)
        assert quantize._calibration_tree(model) == {}
    with layers.calibrating() if mode == "dynamic" else nullcontext():
        (boxes, scores), outs, qs = port_apply(model, x)
    assert_cells_match(outs, qs, inter, jqs, 72)
    np.testing.assert_allclose(boxes.numpy(), jboxes, **MAP_TOL)
    np.testing.assert_allclose(scores.numpy(), jscores, **MAP_TOL)
    if mode == "dynamic":
        assert_calib_matches(model, jcalib)
    ids, sc, bb = detections(boxes.numpy(), scores.numpy(), SIZE)
    assert_detections_match((ids, sc, bb), detections(jboxes, jscores, SIZE))


@pytest.mark.parametrize("mode", ["static", "dynamic", "fused"])
def test_head_only_int8_matches_jax(mode):
    """The head-only YOLOv3 (`use_backbone=False`) over three float32 routes
    in each int8 mode: JAX's conversion (`quantize_static`,
    `quantize_fused`, or the dynamic variables) bridged, the first cell of
    each block quantising its real-valued input; the int8 operands bit for
    bit, the cells' real outputs, the prediction maps and the detections.
    The port's own conversion gives JAX's variables bit for bit."""
    jm = JaxYOLOv3(num_classes=NC, use_backbone=False, channels=(32, 16, 8))
    rs = np.random.RandomState(21)
    routes = tuple((rs.randn(2, SIZE // s, SIZE // s, c) * 0.5).astype(np.float32)
                   for s, c in ((8, 256), (16, 512), (32, 1024)))
    variables = float_variables(jm, routes, 22)
    calib = [tuple(jnp.asarray(r) for r in routes)]
    if mode == "static":
        qm, qvars = jquantize.quantize_static(jm, variables, calib)
    elif mode == "fused":
        qm, qvars = jquantize.quantize_fused(jm, variables, calib)
    else:
        qm, qvars = jquantize.replace_quant(jm, True), jquantize.quantize_detector_variables(variables)
    (jboxes, jscores), inter, jqs, _ = jax_apply(qm, qvars, routes)
    port_kw = dict(num_classes=NC, use_backbone=False, channels=(32, 16, 8))
    model = load(YOLOv3(quant={"static": "static", "fused": "fused", "dynamic": True}[mode], **port_kw), qvars)
    (boxes, scores), outs, qs = port_apply(model, tuple(torch.from_numpy(r) for r in routes))
    assert len(qs) == len(jqs) == 20
    for a, b in zip(qs, jqs):
        np.testing.assert_array_equal(a, b)
    real = {n: o for n, o in outs.items() if o.dtype == np.float32 and not isinstance(inter[n], tuple)}
    assert len(real) == (3 if mode == "fused" else 20)
    for name, o in real.items():
        np.testing.assert_allclose(o, inter[name], err_msg=name, **CELL_TOL)
    np.testing.assert_allclose(boxes.numpy(), jboxes, **MAP_TOL)
    np.testing.assert_allclose(scores.numpy(), jscores, **MAP_TOL)
    assert_detections_match(detections(boxes.numpy(), scores.numpy(), SIZE), detections(jboxes, jscores, SIZE))
    if mode != "dynamic":
        fm = YOLOv3(**port_kw)
        fm.load_state_dict(flax_to_state_dict(variables), strict=True)
        convert = quantize.quantize_static if mode == "static" else quantize.quantize_fused
        _, ours = convert(fm.eval(), state_dict_to_flax(fm.state_dict()), [tuple(torch.from_numpy(r) for r in routes)])
        assert_same_tree(ours, jax.tree_util.tree_map(np.asarray, qvars))


# --- Detector and the detect twin ---------------------------------------------

def test_detector_int8_modes_match_jax(yolo_jax):
    """`Detector(quantize=..., device="cpu")` on YOLOv3: "int8_static" from
    the float variables calibrated on the same two image batches,
    "int8_static" from JAX's static variables as they are, "int8_dynamic"
    from the float variables (no calibration) and from JAX's dynamic
    variables; each gives JAX's detections on the first batch."""
    cfg = YoloConfig(num_classes=NC, pad_stem=True)
    images = yolo_jax["images"]
    for mode, qname in (("static", "int8_static"), ("dynamic", "int8_dynamic")):
        (jboxes, jscores), _, _, _ = yolo_jax["runs"][mode]
        want = detections(jboxes, jscores, SIZE)
        dets = [Detector(cfg, yolo_jax["variables"], data_shape=SIZE, device="cpu", quantize=qname,
                         calibration=images if mode == "static" else None),
                Detector(cfg, yolo_jax["qvars"][mode], data_shape=SIZE, device="cpu", quantize=qname)]
        for det in dets:
            assert det.model.init_kwargs["quant"] == MODES[mode]
            assert_detections_match(det(images[0]), want)
    with pytest.raises(ValueError, match="calibrates"):
        Detector(cfg, data_shape=SIZE, device="cpu", quantize="int8_static")
    with pytest.raises(ValueError, match="quantize must be one of"):
        Detector(cfg, data_shape=SIZE, device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="int8 variables serve"):
        Detector(cfg, yolo_jax["qvars"]["static"], data_shape=SIZE, device="cpu")


@pytest.mark.parametrize("flag", ["int8_static", "int8_dynamic"])
def test_detect_twin_synthetic_quantize(flag):
    """`python -m videoyolo_torch.detect --quantize int8_static|int8_dynamic`
    on the CPU: its predictions equal an in-process `Detector` with the
    same seed, calibrated (static) on the first two request batches."""
    argv = ["--data_shape", str(SIZE), "--batch_size", "2", "--num_requests", "2", "--device", "cpu",
            "--quantize", flag, "--seed", "3"]
    preds = detect.main(argv)
    requests = list(detect._requests(np.random.RandomState(3), 2, 2, SIZE, 1, 1))
    det = Detector(YoloConfig(num_classes=detect.NUM_CLASSES, pad_stem=True), data_shape=SIZE, device="cpu",
                   seed=3, quantize=flag, calibration=requests[:2] if flag == "int8_static" else None)
    assert det.model.init_kwargs["quant"] == ("static" if flag == "int8_static" else True)
    want = {}
    for r, batch in enumerate(requests):
        ids, sc, bb = (a.numpy() for a in det(batch))
        for i in range(ids.shape[0]):
            detect.collect_boxes(want, f"request{r}/image{i:04d}", ids[i], sc[i], bb[i], SIZE)
    assert sorted(preds) == sorted(want) and sum(map(len, want.values())) > 0
    for name in want:
        np.testing.assert_array_equal(np.asarray(preds[name]), np.asarray(want[name]))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return write_voc_tree(tmp_path_factory.mktemp("voc_int8"), n=5, seed=4)


@pytest.mark.parametrize("flag", ["int8", "int8_static", "int8_dynamic"])
def test_dataset_path_serves_quantize(voc_root, tmp_path, flag):
    """The dataset path's `--quantize` (once ignored: the float model
    served): its pred/ cache equals an in-process `Detector(quantize=...)`
    calibrated on the loader's first two batches (none for int8_dynamic),
    run over the same loader; int8 is the fused model on YOLOv3, as
    detect_yolo3.py:374-381 rules.  Without --quantize the cache differs."""
    common = ["--dataset", "voc", "--dataset_root", voc_root, "--data_shape", str(SIZE), "--batch_size", "2",
              "--device", "cpu", "--save_dir", str(tmp_path), "--num_workers", "1", "--seed", "5"]
    preds = detect.main(common + ["--save_prefix", flag, "--quantize", flag])
    dataset = detect.get_dataset(["voc"], voc_root)
    cache = detect.load_predictions(str(tmp_path / flag), dataset)
    loader = detect.DetectionLoader(dataset, batch_size=2, num_workers=1, native_decode=(SIZE, SIZE))
    calibration = None if flag == "int8_dynamic" else [b["image"] for b in itertools.islice(iter(loader), 2)]
    det = Detector(YoloConfig(num_classes=20), data_shape=SIZE, device="cpu", seed=5, quantize=flag,
                   calibration=calibration)
    assert det.model.init_kwargs["quant"] == {"int8": "fused", "int8_static": "static", "int8_dynamic": True}[flag]
    want = detect.detect_dataset(det, dataset, loader)
    paths = [dataset.sample_path(i) for i in range(len(dataset))]
    assert sum(len(want.get(p, [])) for p in paths) > 0
    for p in paths:
        assert cache.get(p, []) == preds[p]
        np.testing.assert_allclose(np.asarray(cache.get(p, [])).reshape(-1, 6),
                                   np.asarray(want.get(p, [])).reshape(-1, 6), rtol=0, atol=1e-6)
    if flag == "int8":
        float_preds = detect.main(common + ["--save_prefix", "float"])
        assert any(float_preds[p] != preds[p] for p in paths)
