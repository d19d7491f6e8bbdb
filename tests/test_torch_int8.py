"""The port's slice 3 (fused-int8 YOLOv3 serving) against the JAX package,
on the CPU: the quantisation functions, K3's plain version against the
Pallas kernel in interpret mode, the direct int8 cell, the int8 joins, the
whole fused-int8 YOLOv3 in both `ds_conv` modes, the conversion, the
`Detector` and the entry point, and the guards.

Inputs and weights are made with numpy from a seed and handed to both
packages.  The JAX package runs under jit, as it serves: there XLA
contracts `acc * scale + bias` (and the residual join's first product and
sum) into one fused multiply-add, and the port rounds them once too.  The
int8 activations are compared bit for bit, the boxes and scores (a float32
prediction conv, summed in another order) within rtol=atol=1e-5."""
import contextlib
import functools
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

import chip_smoke
import videoyolo_tpu.ops.pallas_conv as jpallas_conv
from videoyolo_tpu.data.transforms import to_normalized as jax_to_normalized
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.yolo3 import YOLOv3 as JaxYOLOv3
from videoyolo_tpu.models.yolo3 import postprocess as jax_postprocess
from videoyolo_tpu.ops import quantize as jquantize
from videoyolo_torch import detect
from videoyolo_torch.models import layers
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.yolo3 import YOLOv3
from videoyolo_torch.ops import int8_conv_kernel, quantize
from videoyolo_torch.ops.int8_conv import int8_conv_plain, quant_downsample, quant_downsample_plain
from videoyolo_torch.serving import Detector
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SIZE = 64
TOL = dict(rtol=1e-5, atol=1e-5)  # the float32 prediction conv, summed in another order
DS_CONV = ("direct", "pallas")


def nchw(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    t = t.permute(0, 3, 1, 2)  # an NHWC array as NCHW in channels_last memory
    return t if dtype is None else t.to(dtype)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def float_variables(module, x, seed):
    """Random float32 flax variables: kernels N(0, 1/fan_in) (the prediction
    convs' N(0, 0.01/fan_in), so that the boxes stay near their anchors and
    float32 rounding of their corners stays under the tolerance), BN scale
    and variance in [0.5, 1.5], biases and means N(0, 0.01)."""
    shapes = jax.eval_shape(partial(module.init, train=False), jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            gain = 0.1 if path[-2].key == "prediction" else 1.0
            return (rs.randn(*shape) * gain / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@contextlib.contextmanager
def pallas_interpret():
    """The JAX package's ds_conv="pallas" path on the CPU: its wrapper with
    the Pallas kernel in interpret mode (nothing in the package changes)."""
    orig = jpallas_conv.pallas_quant_downsample
    jpallas_conv.pallas_quant_downsample = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        jpallas_conv.pallas_quant_downsample = orig


# --- the quantisation functions --------------------------------------------

def test_quantize_functions_bit_equal():
    rs = np.random.RandomState(0)
    for shape in [(3, 3, 8, 16), (1, 1, 32, 8), (3, 3, 3, 4, 6)]:
        cout = shape[-1]
        args = (
            rs.randn(*shape).astype(np.float32), rs.uniform(0.5, 1.5, cout).astype(np.float32),
            rs.randn(cout).astype(np.float32), rs.randn(cout).astype(np.float32),
            rs.uniform(0.5, 1.5, cout).astype(np.float32),
        )
        for ours, ref in zip(quantize.fold_bn_cell(*args), jquantize.fold_bn_cell(*args)):
            np.testing.assert_array_equal(ours, ref)
        ours, ref = quantize.quantize_cell(*args), jquantize.quantize_cell(*args)
        assert sorted(ours) == sorted(ref) == ["bias", "qkernel", "wscale"]
        for k in ours:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])
    # the s2d stem's tiled BN
    args = (rs.randn(3, 3, 12, 128).astype(np.float32),) + tuple(
        rs.uniform(0.5, 1.5, 32).astype(np.float32) for _ in range(4))
    np.testing.assert_array_equal(quantize.fold_bn_cell(*args)[0], jquantize.fold_bn_cell(*args)[0])

    model = JaxYOLOv3(num_classes=4, pad_stem=True)
    variables = float_variables(model, np.zeros((1, SIZE, SIZE, 3), np.float32), 1)
    ours = quantize.quantize_detector_variables(variables)
    ref = jquantize.quantize_detector_variables(variables)
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref] and len(flat_ours) > 200
    for (_, a), (_, b) in zip(flat_ours, flat_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="batch_stats"):
        quantize.quantize_detector_variables({"params": variables["params"]})


# --- K3 and the direct int8 cell --------------------------------------------

def _k3_case(b, h, c, f, seed):
    rs = np.random.RandomState(seed)
    q = rs.randint(-127, 128, (b, h, h, c)).astype(np.int8)
    k = rs.randint(-127, 128, (3, 3, c, f)).astype(np.int8)
    scale = (rs.rand(f).astype(np.float32) + 0.5) * 1e-3
    bias = rs.randn(f).astype(np.float32) * 0.1
    return q, k, scale, bias, np.float32(0.05)


def _fma_sensitive_case(c=8, f=16, a=77):
    """One output pixel whose int32 sum is `a` and whose a * scale + bias
    lands on 2.5 when rounded twice but off it when rounded once: the
    requantised int8 shows which the arithmetic did."""
    rs = np.random.RandomState(1)
    scales, biases = [], []
    while len(scales) < f:
        s = np.float32(10 + rs.rand() * 10)
        b = np.float32(np.float64(2.5) - np.float64(np.float32(a * s)))
        once = np.float32(np.float64(a) * np.float64(s) + np.float64(b))
        if np.round(np.float32(np.float32(a * s) + b)) != np.round(once):
            scales.append(s)
            biases.append(b)
    q = np.zeros((1, 8, 8, c), np.int8)
    q[0, 2, 2, 0] = a  # output pixel (1, 1) reads it at its centre tap
    k = np.zeros((3, 3, c, f), np.int8)
    k[1, 1, 0, :] = 1
    return q, k, np.array(scales, np.float32), np.array(biases, np.float32), np.float32(1.0)


def _torch_args(q, k, scale, bias, oscale):
    return nchw(q), nchw(k.transpose(3, 0, 1, 2)), torch.from_numpy(scale), torch.from_numpy(bias), \
        torch.tensor(oscale)


@pytest.mark.parametrize(
    "b,h,c,f,rb",
    [(2, 32, 8, 16, 8), (1, 52, 16, 32, 8), (2, 16, 8, 16, 16), (1, 26, 3, 5, 8)],
    ids=["Hp16", "Hp26_ragged", "Hp8_one_block", "Hp13_C3_F5"],
)
def test_quant_downsample_plain_matches_pallas(b, h, c, f, rb):
    """K3's plain version against the Pallas kernel (interpret mode), bit
    for bit, on the cases of tests/test_pallas_conv.py and a 13x13 output of
    3 channels in, 5 out."""
    args = _k3_case(b, h, c, f, seed=h + c)
    want = np.asarray(jpallas_conv.pallas_quant_downsample(
        *(jnp.asarray(a) for a in args[:4]), args[4], row_block=rb, interpret=True))
    got = quant_downsample(*_torch_args(*args))
    assert got.dtype == torch.int8 and got.shape == (b, f, h // 2, h // 2)
    np.testing.assert_array_equal(nhwc(got), want)


def test_quant_downsample_rounds_multiply_add_once():
    args = _fma_sensitive_case()
    want = np.asarray(jpallas_conv.pallas_quant_downsample(
        *(jnp.asarray(a) for a in args[:4]), args[4], row_block=8, interpret=True))
    got = nhwc(quant_downsample_plain(*_torch_args(*args)))
    assert (want[0, 1, 1] == 3).all()  # 2.5 + a little, not 2.5 rounded to even
    np.testing.assert_array_equal(got, want)


CELLS = [(1, 1), (3, 1), (3, 2)]


@pytest.mark.parametrize("kernel,stride", CELLS, ids=[f"k{k}s{s}" for k, s in CELLS])
@pytest.mark.parametrize("real_input", [False, True], ids=["qtensor_in", "real_in"])
@pytest.mark.parametrize("qout", [True, False], ids=["qout", "real_out"])
def test_int8_cell_matches_jax(kernel, stride, real_input, qout):
    """The direct int8 cell (`ConvBNLeaky(quant="fused")`, int8_conv_plain
    on the CPU) against the JAX cell under jit, bit for bit."""
    rs = np.random.RandomState(kernel * 10 + stride)
    c, f = 16, 24
    x = rs.randn(2, 10, 10, c).astype(np.float32)
    q = rs.randint(-127, 128, (2, 10, 10, c)).astype(np.int8)
    params = {
        "qkernel": rs.randint(-127, 128, (kernel, kernel, c, f)).astype(np.int8),
        "wscale": (rs.rand(f).astype(np.float32) + 0.5) * 1e-2,
        "bias": rs.randn(f).astype(np.float32) * 0.1,
    }
    if real_input:
        params["xscale"] = np.float32(0.031)
    if qout:
        params["oscale"] = np.float32(0.27)
    jcell = jlayers.ConvBNLeaky(f, kernel=kernel, stride=stride, quant="fused", qout=qout)
    s_in = np.float32(0.013)
    jin = jnp.asarray(x) if real_input else jlayers.QTensor(jnp.asarray(q), jnp.asarray(s_in))
    want = jax.jit(lambda v, a: jcell.apply(v, a))({"params": params}, jin)

    cell = layers.ConvBNLeaky(c, f, kernel, stride, quant="fused", qout=qout, real_input=real_input)
    cell.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    got = cell(nchw(x) if real_input else layers.QTensor(nchw(q), torch.tensor(s_in)))
    if qout:
        assert isinstance(got, layers.QTensor) and got.s.item() == params["oscale"]
        assert got.q.dtype == torch.int8 and got.q.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(nhwc(got.q), np.asarray(want.q))
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_int8_cell_rounds_multiply_add_once():
    """The crafted case through the jitted JAX direct cell and the port's."""
    q, k, scale, bias, oscale = _fma_sensitive_case()
    params = {"qkernel": k, "wscale": scale, "bias": bias, "oscale": oscale}
    jcell = jlayers.ConvBNLeaky(16, kernel=3, stride=2, quant="fused")
    want = jax.jit(lambda v, a: jcell.apply(v, jlayers.QTensor(a, jnp.float32(1.0))))(
        {"params": params}, jnp.asarray(q))
    assert (np.asarray(want.q)[0, 1, 1] == 3).all()
    got = int8_conv_plain(nchw(q), nchw(k.transpose(3, 0, 1, 2)), 2, torch.from_numpy(scale),
                          torch.from_numpy(bias), torch.tensor(oscale))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want.q))


def test_int8_joins_match_jax():
    """QuantResidual (calibrated and calibrating), quant_concat and the int8
    upsample against the JAX package under jit, bit for bit."""
    rs = np.random.RandomState(7)
    qa, qb = (rs.randint(-127, 128, (2, 6, 6, 8)).astype(np.int8) for _ in range(2))
    sa, sb, xs = np.float32(0.0123), np.float32(0.0456), np.float32(0.051)
    ja = jlayers.QTensor(jnp.asarray(qa), jnp.asarray(sa))
    jb = jlayers.QTensor(jnp.asarray(qb), jnp.asarray(sb))
    ta, tb = layers.QTensor(nchw(qa), torch.tensor(sa)), layers.QTensor(nchw(qb), torch.tensor(sb))

    want = jax.jit(lambda v, a, b: jlayers.QuantResidual().apply(v, a, b))({"params": {"xscale": xs}}, ja, jb)
    join = layers.QuantResidual()
    join.load_state_dict({"xscale": torch.tensor(xs)})
    got = join(ta, tb)
    np.testing.assert_array_equal(nhwc(got.q), np.asarray(want.q))
    assert got.s.item() == xs and got.host == float(xs)

    want, sown = jax.jit(lambda a, b: jlayers.QuantResidual(calib=True).apply(
        {}, a, b, mutable=["quant_calib"]))(ja, jb)
    join = layers.QuantResidual(calib=True)
    got = join(ta, tb)
    np.testing.assert_array_equal(nhwc(got.q), np.asarray(want.q))
    assert got.s.item() == np.asarray(want.s)
    assert join.calib["amax"].item() == np.asarray(sown["quant_calib"]["amax"][0])

    want = jax.jit(jlayers.quant_concat)([ja, jb])
    got = layers.quant_concat([ta, tb])
    assert got.q.shape == (2, 16, 6, 6) and got.s.item() == np.asarray(want.s)
    np.testing.assert_array_equal(nhwc(got.q), np.asarray(want.q))

    up = layers.upsample2x(ta.q)
    assert up.dtype == torch.int8 and up.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(up), np.asarray(jlayers.upsample2x(jnp.asarray(qa))))


# --- the whole slice ---------------------------------------------------------

def _intermediates(tree, path=()):
    """{module path: output} of flax's captured intermediates."""
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            out[".".join(path)] = v[0]
        else:
            out.update(_intermediates(v, path + (k,)))
    return out


@pytest.fixture(scope="module")
def fused_jax():
    """JAX YOLOv3(num_classes=4, pad_stem=True) in float32 at 64 px, B=2:
    its float variables, the calibration batch, `quantize_fused`, and under
    jit every cell's output and the detect outputs for ds_conv "direct" and
    "pallas" (the Pallas kernel in interpret mode)."""
    model = JaxYOLOv3(num_classes=4, pad_stem=True)
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    x = jax_to_normalized(images)
    variables = float_variables(model, np.zeros((1, SIZE, SIZE, 3), np.float32), 5)
    qmodel, qvars = jquantize.quantize_fused(model, variables, [x])
    runs = {}
    for ds_conv in DS_CONV:
        m = qmodel.clone(ds_conv=ds_conv)
        with pallas_interpret():
            out, state = jax.jit(lambda v, xx: m.apply(  # noqa: B023
                v, xx, train=False, capture_intermediates=True, mutable=["intermediates"]))(qvars, x)
        runs[ds_conv] = (jax.tree_util.tree_map(np.asarray, out),
                         _intermediates(jax.tree_util.tree_map(np.asarray, state["intermediates"])))
    return dict(variables=variables, images=images, x=np.asarray(x), qvars=qvars, runs=runs)


def _port_model(qvars, ds_conv):
    m = YOLOv3(num_classes=4, pad_stem=True, quant="fused", ds_conv=ds_conv)
    m.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, qvars)), strict=True)
    return m.eval().to(memory_format=torch.channels_last)


def test_quantize_fused_matches_jax(fused_jax):
    """The port's conversion, on the bridged float weights and the same
    calibration batch, gives JAX's int8 variables: every qkernel bit for
    bit, the scales within rtol 1e-6."""
    fm = YOLOv3(num_classes=4, pad_stem=True)
    fm.load_state_dict(flax_to_state_dict(fused_jax["variables"]), strict=True)
    fm.eval()
    ours_m, ours = quantize.quantize_fused(fm, state_dict_to_flax(fm.state_dict()), [torch.from_numpy(fused_jax["x"])])
    assert ours_m.init_kwargs["quant"] == "fused" and not ours_m.training
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(fused_jax["qvars"])[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_ours] == [jax.tree_util.keystr(p) for p, _ in flat_ref]
    names = {jax.tree_util.keystr(p).split("'")[-2] for p, _ in flat_ref}
    assert {"qkernel", "wscale", "bias", "xscale", "oscale", "kernel"} <= names
    for (p, a), (_, b) in zip(flat_ours, flat_ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(p)
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("ds_conv", DS_CONV)
def test_fused_yolov3_matches_jax(fused_jax, ds_conv):
    """JAX's int8 variables, bridged: every cell and join's int8 output (and
    the real-valued tips) bit for bit, the boxes and scores within 1e-5."""
    (jboxes, jscores), inter = fused_jax["runs"][ds_conv]
    model = _port_model(fused_jax["qvars"], ds_conv)
    outs = {}
    hooks = [m.register_forward_hook(lambda mod, i, o, n=n: outs.__setitem__(n, o))
             for n, m in model.named_modules() if isinstance(m, (layers.ConvBNLeaky, layers.QuantResidual))]
    with torch.inference_mode():
        boxes, scores = model(torch.from_numpy(fused_jax["x"]))
    for h in hooks:
        h.remove()
    assert len(outs) == 72 + 23 and all(n in inter for n in outs)
    tips = 0
    for name, o in outs.items():
        ref = inter[name]
        if isinstance(o, layers.QTensor):
            assert o.q.dtype == torch.int8 and o.s.item() == np.asarray(ref.s), name
            np.testing.assert_array_equal(nhwc(o.q), ref.q, err_msg=name)
        else:
            tips += 1
            np.testing.assert_array_equal(nhwc(o), ref, err_msg=name)
    assert tips == 3
    np.testing.assert_allclose(boxes.numpy(), jboxes, **TOL)
    np.testing.assert_allclose(scores.numpy(), jscores, **TOL)


def test_pallas_mode_takes_k3_on_its_cells(fused_jax, monkeypatch):
    """ds_conv="pallas" sends exactly the JAX package's eligible cells to
    K3: the downsamples whose int8 input has an even H of at most 208 rows
    (at 64 px all five; at 416 px the first one's 416 rows keep it off)."""
    from videoyolo_torch.ops import int8_conv as ops_int8

    calls = []
    orig = ops_int8.quant_downsample_plain
    monkeypatch.setattr(ops_int8, "quant_downsample_plain", lambda q, *a: calls.append(q.shape) or orig(q, *a))
    model = _port_model(fused_jax["qvars"], "pallas")
    with torch.inference_mode():
        model(torch.from_numpy(fused_jax["x"]))
    assert calls == [(2, 32, 64, 64), (2, 64, 32, 32), (2, 128, 16, 16), (2, 256, 8, 8), (2, 512, 4, 4)]
    cell = model.backbone.stage1.ConvBNLeaky_0
    big = layers.QTensor(torch.zeros((1, 32, 210, 210), dtype=torch.int8), torch.tensor(1.0))
    odd = layers.QTensor(torch.zeros((1, 32, 13, 13), dtype=torch.int8), torch.tensor(1.0))
    assert cell._k3_eligible(layers.QTensor(torch.zeros((1, 32, 208, 208), dtype=torch.int8), torch.tensor(1.0)))
    assert not cell._k3_eligible(big) and not cell._k3_eligible(odd)


# --- entry points ------------------------------------------------------------

def _jax_detect(fused_jax, ds_conv="direct"):
    (boxes, scores), _ = fused_jax["runs"][ds_conv]
    ids, sc, bb = jax_postprocess(jnp.asarray(boxes), jnp.asarray(scores), nms_thresh=0.45, nms_topk=400)
    return np.asarray(ids), np.asarray(sc), np.asarray(bb).clip(0, SIZE)


def test_detector_int8_matches_jax(fused_jax):
    """`Detector(quantize="int8", device="cpu")`: with the JAX package's int8
    variables, and with its float variables calibrated on the same images;
    both give JAX's detections (every row's id, and score and box within
    1e-4)."""
    cfg = YoloConfig(num_classes=4, pad_stem=True)
    dets = [
        ("direct", Detector(cfg, jax.tree_util.tree_map(np.asarray, fused_jax["qvars"]), data_shape=SIZE,
                            device="cpu", quantize="int8")),
        ("pallas", Detector(cfg, fused_jax["variables"], data_shape=SIZE, device="cpu", quantize="int8",
                            calibration=[fused_jax["images"]], ds_conv="pallas")),
    ]
    for ds_conv, det in dets:
        rids, rsc, rbb = _jax_detect(fused_jax, ds_conv)
        ids, sc, bb = (a.numpy() for a in det(fused_jax["images"]))
        assert ids.shape == rids.shape == (2, 100, 1) and (ids >= 0).sum() > 0
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_allclose(sc, rsc, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bb, rbb, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="calibration"):
        Detector(cfg, data_shape=SIZE, device="cpu", quantize="int8")
    with pytest.raises(ValueError, match="quantize='int8'"):
        Detector(cfg, jax.tree_util.tree_map(np.asarray, fused_jax["qvars"]), data_shape=SIZE, device="cpu")
    # the static mode calibrates too; "int8" on a window model serves the
    # static one (item 9a, tests/test_torch_int8_temporal.py)
    with pytest.raises(ValueError, match="calibrates"):
        Detector(cfg, data_shape=SIZE, device="cpu", quantize="int8_static")
    windows = np.stack([fused_jax["images"]] * 3, axis=1)
    det = Detector(YoloConfig(num_classes=4, k=3), data_shape=SIZE, device="cpu", quantize="int8",
                   calibration=[windows])
    assert det.model.quant == "static" and det(windows)[0].shape == (2, 100, 1)


def test_detect_quantize_int8_on_cpu(capsys):
    preds = detect.main([
        "--data_shape", str(SIZE), "--batch_size", "2", "--num_requests", "2", "--device", "cpu",
        "--dtype", "bf16", "--quantize", "int8",
    ])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("request")]
    assert len(lines) == 2 and "on cpu" in lines[0]
    assert len(preds) == 4 and sum(len(v) for v in preds.values()) > 0
    for entries in preds.values():
        assert all(len(e) == 6 and 0 <= e[0] < 20 and 0 <= min(e[2:]) and max(e[2:]) <= 1 for e in entries)
    # the dynamic mode and the static window model serve too (item 9a,
    # tests/test_torch_int8_modes.py and test_torch_int8_temporal.py)
    for flags in (["--quantize", "int8_dynamic"], ["--quantize", "int8", "--window", "3"]):
        preds = detect.main(["--data_shape", str(SIZE), "--batch_size", "1", "--num_requests", "1",
                             "--device", "cpu", *flags])
        assert len(preds) == 1 and all(len(e) == 6 for v in preds.values() for e in v)


# --- the int8 kernels' plan --------------------------------------------------

def _recorded_cells(ds_conv, size=416):
    """Every int8 conv of one B=1 request of the fused-int8 YOLOv3(20,
    pad_stem) at `size` px: ("conv" | "k3", (b, h, w, c), f, k, stride).
    The convs are recorded and answered with zeros of the right shape; the
    joins between them run as they are."""
    cells = []

    def conv(q, qkernel, stride=1, scale=None, bias=None, oscale=None, out_dtype=torch.float32):
        b, c, h, w = q.shape
        f, _, k, _ = qkernel.shape
        cells.append(("conv", (b, h, w, c), f, k, stride))
        dtype = torch.int32 if scale is None else torch.int8 if oscale is not None else out_dtype
        ho, wo = int8_conv_kernel.out_size(h, k, stride), int8_conv_kernel.out_size(w, k, stride)
        return torch.zeros((b, f, ho, wo), dtype=dtype).to(memory_format=torch.channels_last)

    def k3(q, qkernel, scale, bias, oscale):
        b, c, h, w = q.shape
        cells.append(("k3", (b, h, w, c), qkernel.shape[0], 3, 2))
        return torch.zeros((b, qkernel.shape[0], (h + 1) // 2, (w + 1) // 2),
                           dtype=torch.int8).to(memory_format=torch.channels_last)

    model = YOLOv3(num_classes=20, pad_stem=True, quant="fused", ds_conv=ds_conv).eval()
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        mp.setattr(layers, "int8_conv", conv)
        mp.setattr(layers, "quant_downsample", k3)
        model.to(memory_format=torch.channels_last)(torch.zeros((1, size, size, 3)))
    return cells


@pytest.fixture(scope="module")
def model_cells():
    """The 72 direct cells of a "direct" request and the 4 K3 cells of a
    "pallas" request at 416 px."""
    direct = _recorded_cells("direct")
    k3 = [cell for cell in _recorded_cells("pallas") if cell[0] == "k3"]
    assert len(direct) == 72 and all(cell[0] == "conv" for cell in direct) and len(k3) == 4
    return direct + k3


def _intended(c, f):
    """(route, BN) that a cell of C input and F output channels should get
    with aligned pointers: wgmma for C % 16 == 0 with BN 32, 64 or 128 (the
    least that covers F, at most 128); else mma.sync, 4-byte copies for
    C % 4 == 0, single bytes otherwise, with BN 32 or 64."""
    if c % 16 == 0:
        return "wgmma", (32 if f <= 32 else 64 if f <= 64 else 128)
    return ("mma_word" if c % 4 == 0 else "mma_byte"), (32 if f <= 32 else 64)


def _assert_plan(b, h, w, c, f, k, stride):
    """The plan of a cell whose pointers are 16-byte aligned, as the
    allocator gives them."""
    pl = int8_conv_kernel.plan(b, h, w, c, f, k, stride, int8_conv_kernel.alignment(c, 4096, 8192))
    m = b * int8_conv_kernel.out_size(h, k, stride) * int8_conv_kernel.out_size(w, k, stride)
    assert (pl.route, pl.bn) == _intended(c, f), (b, h, w, c, f, k, stride)
    deep = pl.route == "wgmma" and pl.bn == 128 and k * k * c >= int8_conv_kernel.DEEP_K
    assert pl.bm == 128 and (pl.bk, pl.stages) == ((128, 3) if deep else (64, 4 if pl.route == "wgmma" else 3))
    assert pl.smem <= 232448  # the shared memory one CTA of an H100 may hold
    assert pl.grid == -(-m // pl.bm) * -(-f // pl.bn) and pl.grid <= int8_conv_kernel.MAX_GRID
    return pl


@pytest.mark.parametrize("index", range(76))
def test_plan_of_model_cells(model_cells, index):
    """Each int8 conv of the 416-px model gets its intended route and tile
    at B=1 and B=128: the stem (C = 4) mma_word with a 32-wide N tile,
    every other cell wgmma."""
    kind, (_, h, w, c), f, k, stride = model_cells[index]
    for b in (1, 128):
        pl = _assert_plan(b, h, w, c, f, k, stride)
        if c == 4:
            assert (kind, h, k, pl.route, pl.bn) == ("conv", 416, 3, "mma_word", 32)
        else:
            assert pl.route == "wgmma"


@pytest.mark.parametrize(
    "name,b,h,c,f,k,stride",
    [case for case in chip_smoke.CONV_CASES]
    + [(f"K3_{name}", b, h, c, f, 3, 2) for name, b, h, c, f in chip_smoke.K3_EDGE],
    ids=lambda v: v if isinstance(v, str) else None,
)
def test_plan_of_card_cases(name, b, h, c, f, k, stride):
    """The edge cases that chip_smoke.py holds against the plain versions
    get the route and tile their shapes call for."""
    _assert_plan(b, h, h, c, f, k, stride)


def test_plan_narrows_on_misaligned_pointers():
    assert int8_conv_kernel.alignment(64, 4096, 8192) == 16
    assert int8_conv_kernel.alignment(64, 4096, 8196) == 4
    assert int8_conv_kernel.alignment(64, 4097, 8192) == 1
    assert int8_conv_kernel.alignment(36, 4096, 8192) == 4
    shape = (8, 52, 52, 256, 128, 3, 1)
    routes = [int8_conv_kernel.plan(*shape, align).route for align in (16, 4, 1)]
    assert routes == ["wgmma", "mma_word", "mma_byte"]


# --- guards ------------------------------------------------------------------

def test_deferred_int8_options_raise():
    with pytest.raises(NotImplementedError, match="item 9b"):
        YOLOv3(num_classes=4, quant="fused", ds_conv="s2d")
    with pytest.raises(NotImplementedError, match="item 9c"):
        YOLOv3(num_classes=4, quant="fused", s2d_stem=True)
    # item 9a's static mode and head-only model are built now
    # (tests/test_torch_int8_modes.py); its two-stream model is deferred
    with torch.device("meta"):
        static = YOLOv3(num_classes=4, quant="static")
        head = YOLOv3(num_classes=4, quant="fused", use_backbone=False)
        quantize.assert_quantizable(build_model(YoloConfig(num_classes=2, k=3)))
        with pytest.raises(NotImplementedError, match="item 9a"):
            quantize.assert_quantizable(build_model(YoloConfig(num_classes=2, k=3, motion_stream="flownet")))
    assert sum(k.endswith("xscale") for k in static.state_dict()) == 72
    assert {k for k in head.state_dict() if k.endswith("xscale")} == {f"block{i}.ConvBNLeaky_0.xscale" for i in range(3)}


def test_int8_kernel_entries_raise_on_cpu_tensors():
    q = torch.zeros((1, 16, 8, 8), dtype=torch.int8).to(memory_format=torch.channels_last)
    k = torch.zeros((8, 16, 3, 3), dtype=torch.int8).to(memory_format=torch.channels_last)
    v = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        int8_conv_kernel.int8_conv(q, k, 1, v, v, torch.tensor(1.0))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        int8_conv_kernel.quant_downsample(q, k, v, v, torch.tensor(1.0))
    assert int8_conv_kernel.int8_conv.launches == 0 and int8_conv_kernel.quant_downsample.launches == 0


def test_int8_modules_import_no_jax():
    code = (
        "import sys\n"
        "import videoyolo_torch.ops.quantize, videoyolo_torch.ops.int8_conv\n"
        "import videoyolo_torch.ops.int8_conv_kernel, videoyolo_torch.serving\n"
        "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'videoyolo_tpu')])\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PATH", "PYTHONPATH")}
    env["PATH"] = ""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", (proc.stdout, proc.stderr)
