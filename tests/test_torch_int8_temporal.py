"""The port's int8 dynamic and static modes on the temporal family (ROADMAP.md
item 9a) against the JAX package, on the CPU: the 3-D int8 conv (its plain
version against `jax.lax.conv_general_dilated` with int32 sums, exactly, and
the card's fold of the time taps into channels against it), the 3-D and
2+1D int8 cells, YOLOv3T (k=3 with the early correlation, the '3' and '21'
blocks, the conv-RNN `late` and `out` in mixed precision) and
YOLOv3Temporal (the t=5 correlation pyramid with t_out, the 5 -> 3 -> 1
funnel without), `Detector` and the detect twin on windows, and the
refusals beside the JAX package's.

64 px, 3 classes, FPN channels (16, 8, 4) over the full Darknet-53,
windows from a seed (one a batch where the scales are calibrated, two where
each window takes its own), the JAX package under jit.  The comparisons are those
of tests/test_torch_int8_modes.py, whose helpers this file uses: the
calibrated `xscale` tree bit for bit, every int8 operand bit for bit, the
cells' float32 outputs within 1e-6, the prediction maps within 1e-5, the
detections' ids exactly and their boxes and scores within 1e-4.  The cost
volumes, which both packages sum over the channels in their own order, come
on both sides from one float64 computation rounded to float32 (the port's
`correlation_plain` in float64, through a callback on the JAX side), so the
int8 cells after them see the same inputs; tests/test_torch_temporal.py and
tests/test_torch_tout.py hold the correlation itself to the JAX package."""
from contextlib import contextmanager, nullcontext
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videoyolo_tpu.ops.correlation as jcorrelation
from test_torch_int8_modes import (
    assert_calib_matches, assert_cells_match, assert_detections_match, assert_same_tree, detections, jax_apply,
    leaf_names, load, port_apply, random_variables,
)
from videoyolo_tpu.data.transforms import to_normalized as jax_to_normalized
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.darknet3d import Darknet3D as JaxDarknet3D
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.models.yolo3_temporal import YOLOv3Temporal as JaxYOLOv3Temporal
from videoyolo_tpu.ops import quantize as jquantize
from videoyolo_torch import detect, streaming
from videoyolo_torch.models import darknet3d, layers
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.ts_darknet import TwoStreamDarknet
from videoyolo_torch.models.yolo3 import postprocess_tout
from videoyolo_torch.models.yolo3_temporal import YOLOv3T, YOLOv3Temporal
from videoyolo_torch.ops import int8_conv, quantize
from videoyolo_torch.ops.correlation import correlation_plain
from videoyolo_torch.serving import Detector
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

SIZE = 64
NC = 3
CH = (16, 8, 4)
MODES = {"static": "static", "dynamic": True}

# name: (model family, keywords of both packages' constructors, int8 convs)
MODELS = {
    "k3_early_corr": ("T", dict(k=3, k_join_type="max", k_join_pos="late", corr_pos="early", corr_d=2), 72),
    "blocks3": ("T", dict(k=3, k_join_type="max", k_join_pos="late", block_conv_type="3"), 72),
    "blocks21": ("T", dict(k=3, k_join_type="mean", k_join_pos="late", block_conv_type="21"), 81),
    "rnn_late": ("T", dict(k=3, k_join_type="max", k_join_pos="late", rnn_pos="late"), 69),
    "rnn_out": ("T", dict(k=3, k_join_type="max", k_join_pos="late", rnn_pos="out"), 72),
    "tout_pyramid": ("Temporal", dict(t=5, corr_d=2, t_out=True), 75),
    "funnel": ("Temporal", dict(t=5, t_out=False), 76),
}
CASES = [(name, "static") for name in MODELS] + [("blocks21", "dynamic")]


def _corr64(f1, f2, max_displacement, kernel_size=1, stride1=1, stride2=2, is_multiply=True):
    """The cost volume both packages take here: float64 sums, float32."""
    out = correlation_plain(torch.as_tensor(np.asarray(f1)).double(), torch.as_tensor(np.asarray(f2)).double(),
                            max_displacement, kernel_size, stride1, stride2, is_multiply)
    return out.float().numpy()


def _jax_corr64(f1, f2, max_displacement, kernel_size=1, stride1=1, stride2=2, is_multiply=True):
    fn = partial(_corr64, max_displacement=max_displacement, kernel_size=kernel_size, stride1=stride1,
                 stride2=stride2, is_multiply=is_multiply)
    d = 2 * (max_displacement // stride2) + 1
    shape = jax.ShapeDtypeStruct(f1.shape[:3] + (d * d,), jnp.float32)
    return jax.pure_callback(fn, shape, f1, f2)


def _port_corr64(f1, f2, max_displacement, kernel_size=1, stride1=1, stride2=2, is_multiply=True):
    return torch.from_numpy(_corr64(f1, f2, max_displacement, kernel_size, stride1, stride2, is_multiply))


@contextmanager
def shared_cost_volumes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorrelation, "correlation", _jax_corr64)
        mp.setattr(layers, "correlation", _port_corr64)
        yield


def _jax_model(name):
    family, kw, _ = MODELS[name]
    return (JaxYOLOv3T if family == "T" else JaxYOLOv3Temporal)(num_classes=NC, channels=CH, **kw)


def _port_model(name, quant=None):
    family, kw, _ = MODELS[name]
    return (YOLOv3T if family == "T" else YOLOv3Temporal)(num_classes=NC, channels=CH, quant=quant, **kw)


def _windows(name, seed, batches, windows):
    """`batches` batches of `windows` uint8 windows from a seed, and the
    same normalised as the JAX package normalises them."""
    family, kw, _ = MODELS[name]
    t = kw.get("k") or kw.get("t")
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (batches, windows, t, SIZE, SIZE, 3)).astype(np.uint8)
    return images, [np.asarray(jax_to_normalized(im)) for im in images]


# --- the 3-D int8 conv and cells -----------------------------------------------

CONV3D = [  # kernel, stride, padding, T
    ((3, 3, 3), (1, 1, 1), (1, 1, 1), 3),
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), 3),
    ((1, 3, 3), (1, 2, 2), (0, 1, 1), 5),
    ((3, 1, 1), (1, 1, 1), (0, 0, 0), 5),
    ((3, 1, 1), (1, 1, 1), (1, 0, 0), 3),
    ((1, 1, 1), (1, 1, 1), (0, 0, 0), 3),
    ((3, 3, 3), (2, 1, 1), (1, 1, 1), 5),
]


@pytest.mark.parametrize("kernel,stride,padding,t", CONV3D, ids=[f"k{''.join(map(str, c[0]))}s{''.join(map(str, c[1]))}p"
                                                                   f"{''.join(map(str, c[2]))}t{c[3]}" for c in CONV3D])
def test_int8_conv3d_matches_jax(kernel, stride, padding, t):
    """The 3-D int8 conv's plain version against `jax.lax.conv_general_dilated`
    (int8 in, `preferred_element_type=int32`) exactly, with int8 extremes
    (|sum| past 2^24, where float32 would round); the card's route, the kt
    time taps folded into channels (`fold_frames`, `fold_kernel`) through
    the 2-D int8 conv, equal to it; the epilogue, one scale or one a
    window, through both."""
    rs = np.random.RandomState(sum(kernel) + t)
    c, f = 40, 24
    q = rs.randint(-127, 128, (2, t, 9, 9, c)).astype(np.int8)
    q[0] = 127
    k = rs.randint(-127, 128, kernel + (c, f)).astype(np.int8)
    k[..., 0] = 127
    dn = jax.lax.conv_dimension_numbers(q.shape, k.shape, ("NDHWC", "DHWIO", "NDHWC"))
    want = np.asarray(jax.lax.conv_general_dilated(jnp.asarray(q), jnp.asarray(k), stride, [(p, p) for p in padding],
                                                   dimension_numbers=dn, preferred_element_type=jnp.int32))
    tq, tk = torch.from_numpy(q), flax_to_state_dict({"params": {"c": {"qkernel": k}}})["c.qkernel"]
    got = int8_conv.int8_conv3d_plain(tq, tk, stride, padding)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if kernel == (3, 3, 3):
        assert np.abs(want).max() > 2 ** 24
    x, t_out = int8_conv.fold_frames(tq, kernel[0], stride[0], padding[0])
    assert x.is_contiguous(memory_format=torch.channels_last) and t_out == want.shape[1]
    k2 = int8_conv.fold_kernel(tk)
    assert k2.is_contiguous(memory_format=torch.channels_last) and k2.shape == (f, kernel[0] * c) + kernel[1:]
    folded = int8_conv.int8_conv_plain(x, k2, stride[1])
    np.testing.assert_array_equal(folded.permute(0, 2, 3, 1).reshape(want.shape).numpy(), want)
    scale = torch.from_numpy((rs.rand(f).astype(np.float32) + 0.5) * 1e-4)
    bias = torch.from_numpy(rs.randn(f).astype(np.float32))
    per_window = torch.from_numpy((rs.rand(2, f).astype(np.float32) + 0.5) * 1e-4)
    for s in (scale, per_window):
        # the sums as float32, the multiply-add rounded once, leaky in float32
        acc = want.astype(np.float32).astype(np.float64)
        yf = (acc * s.numpy().astype(np.float64).reshape((-1, 1, 1, 1, f)) + bias.numpy()).astype(np.float32)
        ref = np.where(yf > 0, yf, np.float32(0.1) * yf)
        np.testing.assert_array_equal(int8_conv.int8_conv3d(tq, tk, stride, padding, s, bias).numpy(), ref)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cell", ["conv3d_333", "conv21d"])
def test_int8_3d_cells_match_jax(cell, mode):
    """`ConvBNLeaky3D` (3,3,3) and `Conv21D` (its two halves quantising on
    their own) in both modes against the JAX cells under jit, bit for bit,
    with a scale a window in the dynamic mode (one window scaled up 50x);
    the amax recorded while calibrating equals the one JAX sows, and a
    call outside calibration records nothing."""
    rs = np.random.RandomState(31)
    c, f = 8, 16
    x = rs.randn(2, 3, 6, 6, c).astype(np.float32)
    x[1] *= 50
    if cell == "conv21d":
        jc, pc = jlayers.Conv21D(f, quant=MODES[mode]), layers.Conv21D(c, f, quant=MODES[mode])
        halves = {"ConvBNLeaky3D_0": ((1, 3, 3), c, f), "ConvBNLeaky3D_1": ((3, 1, 1), f, f)}
    else:
        jc, pc = jlayers.ConvBNLeaky3D(f, quant=MODES[mode]), layers.ConvBNLeaky3D(c, f, quant=MODES[mode])
        halves = {None: ((3, 3, 3), c, f)}
    params = {}
    for name, (k, cin, cout) in halves.items():
        p = {"qkernel": rs.randint(-127, 128, k + (cin, cout)).astype(np.int8),
             "wscale": (rs.rand(cout).astype(np.float32) + 0.5) * 1e-2,
             "bias": rs.randn(cout).astype(np.float32) * 0.1}
        if mode == "static":
            p["xscale"] = np.float32(0.043)
        params.update({name: p} if name else p)
    want, sown = jax.jit(lambda v, a: jc.apply(v, a, mutable=["quant_calib"]))({"params": params}, x)
    pc.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    got = pc(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mode == "dynamic":
        assert quantize._calibration_tree(pc) == {}
        with layers.calibrating():
            np.testing.assert_array_equal(pc(torch.from_numpy(x)).numpy(), np.asarray(want))
        assert_calib_matches(pc, jax.tree_util.tree_map(np.asarray, sown.get("quant_calib", {})))


# --- the models -------------------------------------------------------------------

@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_temporal_int8_matches_jax(name, mode):
    """One configuration in one mode, JAX's conversion against the port's:
    static, the port's `quantize_static` on the same one-window batch gives
    JAX's variables bit for bit (every `xscale` the max over the cell's
    calls on the window's frames or halves; the max over batches is held in
    tests/test_torch_int8_modes.py); then JAX's int8 variables, bridged,
    through the port's model on that batch: the int8 operands bit for bit,
    every int8 cell's output, the prediction maps, the detections.  The conv-RNN's tips and
    outputs stay real-valued (no int8 leaf under `tip_rnn*` or an RNN
    output); dynamic, on a batch of two windows, the 3-D cells scale each
    window by its own amax, and the amax recorded while calibrating is the
    one JAX sows."""
    jm, fm = _jax_model(name), _port_model(name)
    _, xs = _windows(name, seed=len(name), batches=1, windows=1 if mode == "static" else 2)
    variables = random_variables(fm, 7)
    with shared_cost_volumes():
        if mode == "static":
            jq, qvars = jquantize.quantize_static(jm, variables, [jnp.asarray(x) for x in xs])
        else:
            jq, qvars = jquantize.replace_quant(jm, True), jquantize.quantize_detector_variables(variables)
        (jboxes, jscores), inter, jqs, jcalib = jax_apply(jq, qvars, xs[0])
        qvars = jax.tree_util.tree_map(np.asarray, qvars)
        if mode == "static":
            fm.load_state_dict(flax_to_state_dict(variables), strict=True)
            qm, ours = quantize.quantize_static(fm.eval(), state_dict_to_flax(fm.state_dict()),
                                                 [torch.from_numpy(x) for x in xs])
            assert qm.quant == "static" and "xscale" in leaf_names(ours)
            assert_same_tree(ours, qvars)
        model = load(_port_model(name, quant=MODES[mode]), qvars)
        with layers.calibrating() if mode == "dynamic" else nullcontext():
            (boxes, scores), outs, qs = port_apply(model, torch.from_numpy(xs[0]))
    assert_cells_match(outs, qs, inter, jqs, MODELS[name][2])
    if "rnn" in name:
        rnn = [k for k in model.state_dict() if k.startswith("tip_rnn") or ".prediction." in k]
        assert rnn and not any(k.endswith("qkernel") for k in rnn)
    np.testing.assert_allclose(boxes.numpy(), jboxes, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=1e-5, atol=1e-5)
    if mode == "dynamic":
        assert_calib_matches(model, jcalib)
    b = boxes.numpy().reshape((-1,) + boxes.shape[-2:])
    s = scores.numpy().reshape((-1,) + scores.shape[-2:])
    assert_detections_match(detections(b, s, SIZE), detections(jboxes.reshape(b.shape), jscores.reshape(s.shape),
                                                                 SIZE))


# --- Detector, the twin, the refusals ----------------------------------------------

def test_detector_and_twin_on_windows():
    """`Detector(quantize="int8")` on windows serves the static model, as
    detect_yolo3.py:374-381 rules for the temporal family: its detections
    equal, bit for bit, those of the port's `quantize_static` model on the
    same two calibration batches (held to JAX's in
    test_temporal_int8_matches_jax) through `postprocess_tout`, and so do
    those of `Detector(quantize="int8_static")` on that model's int8
    variables as they are; "int8_dynamic" serves the dynamic model, its
    variables `quantize_detector_variables`'.  The synthetic twin's
    `--window 3,1 --quantize int8` equals an in-process Detector calibrated
    on its first two requests."""
    name = "k3_early_corr"
    cfg = YoloConfig(num_classes=NC, **MODELS[name][1])
    fm = build_model(cfg)
    _, xs = _windows(name, seed=41, batches=2, windows=1)
    variables = random_variables(fm, 8)
    fm.load_state_dict(flax_to_state_dict(variables), strict=True)
    qm, qvars = quantize.quantize_static(fm.eval(), variables, [torch.from_numpy(x) for x in xs])
    with torch.inference_mode():
        ids, sc, bb = postprocess_tout(*qm(torch.from_numpy(xs[0])), nms_thresh=0.45, nms_topk=400)
    assert int((ids >= 0).sum()) > 0
    for det in (Detector(cfg, variables, data_shape=SIZE, device="cpu", quantize="int8", calibration=list(xs)),
                Detector(cfg, qvars, data_shape=SIZE, device="cpu", quantize="int8_static")):
        assert det.model.quant == "static"
        for got, want in zip(det(xs[0]), (ids, sc, bb.clamp(0, SIZE))):
            assert torch.equal(got, want)
    dvars = flax_to_state_dict(jquantize.quantize_detector_variables(variables))
    det = Detector(cfg, variables, data_shape=SIZE, device="cpu", quantize="int8_dynamic")
    assert det.model.quant is True and det.model.state_dict().keys() == dvars.keys()
    assert all(torch.equal(t, dvars[k]) for k, t in det.model.state_dict().items())

    argv = ["--data_shape", str(SIZE), "--batch_size", "2", "--num_requests", "2", "--device", "cpu",
            "--window", "3,1", "--k_join_pos", "late", "--corr_pos", "early", "--corr_d", "2", "--quantize", "int8",
            "--seed", "6"]
    preds = detect.main(argv)
    requests = list(detect._requests(np.random.RandomState(6), 2, 2, SIZE, 3, 1))
    tcfg = YoloConfig(num_classes=detect.NUM_CLASSES, pad_stem=True, k=3, k_join_pos="late", corr_pos="early",
                      corr_d=2)
    det = Detector(tcfg, data_shape=SIZE, device="cpu", seed=6, quantize="int8", calibration=requests[:2])
    assert det.model.quant == "static"
    for r, batch in enumerate(requests):
        ids, sc, bb = (a.numpy() for a in det(batch))
        for i in range(ids.shape[0]):
            got = {}
            detect.collect_boxes(got, "w", ids[i], sc[i], bb[i], SIZE)
            assert preds.get(f"request{r}/window{i:04d}", []) == got.get("w", [])


def test_int8_refusals_beside_jax():
    """The refusals the JAX package makes, made the same way: a new_model
    backbone fails `assert_quantizable` with JAX's message, and YOLOv3T
    over it with `quant` fails `_validate`'s backbone assertion (JAX's at
    its first apply, the port's when built); the two-stream int8 model, the
    int8 stream (the model and the twin's flag) and the fused pipeline on
    the temporal family are refused naming item 9a or the static mode."""
    jbb = JaxDarknet3D(conv_types=(2, 3, 3, 2, 2, 2))
    with pytest.raises(AssertionError, match="int8 temporal backbones") as jax_err:
        jquantize.assert_quantizable(JaxYOLOv3T(num_classes=NC, k=5, backbone=jbb))
    with torch.device("meta"):
        bb = darknet3d.Darknet3D((2, 3, 3, 2, 2, 2))
        with pytest.raises(AssertionError) as err:
            quantize.assert_quantizable(YOLOv3T(num_classes=NC, k=5, backbone=bb))
    assert str(err.value) == str(jax_err.value)
    jm = JaxYOLOv3T(num_classes=NC, k=5, backbone=jbb, quant="static")
    with pytest.raises(AssertionError, match="custom backbone must carry the same quant mode") as jax_err:
        jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 5, SIZE, SIZE, 3)))
    with torch.device("meta"):
        with pytest.raises(ValueError) as err:
            YOLOv3T(num_classes=NC, k=5, backbone=darknet3d.Darknet3D((2, 3, 3, 2, 2, 2)), quant="static")
        assert str(err.value) == str(jax_err.value)
        with pytest.raises(NotImplementedError, match="item 9a"):
            quantize.assert_quantizable(build_model(YoloConfig(num_classes=NC, k=3, motion_stream="flownet")))
        with pytest.raises(NotImplementedError, match="item 9a"):
            YOLOv3T(num_classes=NC, k=3, backbone=TwoStreamDarknet(), quant="static")
        with pytest.raises(ValueError, match="fused pipeline is YOLOv3's"):
            YOLOv3Temporal(num_classes=NC, quant="fused")
        model = YOLOv3T(num_classes=NC, k=3, k_join_type="max", k_join_pos="late", quant="static")
        with pytest.raises(ValueError, match="fused int8 pipeline covers YOLOv3"):
            quantize.quantize_fused(YOLOv3Temporal(num_classes=NC, channels=CH), {}, [])
    with pytest.raises(NotImplementedError, match="item 9a"):
        streaming.StreamingDetector(model)
    with pytest.raises(NotImplementedError, match="item 9a"):
        detect.main(["--device", "cpu", "--data_shape", str(SIZE), "--batch_size", "1", "--stream",
                     "--window", "3,1", "--quantize", "int8_static"])
