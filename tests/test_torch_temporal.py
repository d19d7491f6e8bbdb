"""The port's slice 2 (YOLOv3T windows with early correlation) against the
JAX package, on the CPU: the correlation op (against the XLA form and the
Pallas kernel in interpret mode), the temporal layers, Darknet53Stage1,
full-width YOLOv3T in four configurations, the factory, the slice end to
end through `Detector`, and the entry point's temporal flags.

Inputs are made with numpy from a seed and handed to both packages; weights
are random flax variables in the shapes `jax.eval_shape(model.init)` gives,
carried across by the flax bridge."""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoyolo_tpu.data.transforms import to_normalized as jax_to_normalized
from videoyolo_tpu.models import darknet as jdarknet
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.factory import YoloConfig as JaxYoloConfig
from videoyolo_tpu.models.factory import build_model as jax_build_model
from videoyolo_tpu.models.yolo3 import postprocess as jax_postprocess
from videoyolo_tpu.models.yolo3 import select_topk_candidates as jax_select
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.ops.correlation import correlation as jax_correlation
from videoyolo_tpu.ops.pallas_correlation import correlation_pallas
from videoyolo_torch import detect
from videoyolo_torch.models import darknet, layers
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.yolo3_temporal import YOLOv3T
from videoyolo_torch.ops.correlation import correlation, correlation_plain, num_corr_channels
from videoyolo_torch.serving import Detector
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)  # float32 on both sides, other summation orders
CORR_TOL = dict(rtol=1e-5, atol=1e-6)  # the same products, summed in another order
SIZE = 128  # the full-width models' input size
K = 3


def random_variables(module, x, seed, gain=1.0):
    """Random flax variables of `module` at input `x`: kernels N(0,
    gain^2/fan_in), BN scale and variance in [0.5, 1.5], biases and means
    N(0, 0.01)."""
    shapes = jax.eval_shape(partial(module.init, train=False), jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rs.randn(*shape).astype(np.float32) * gain / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# --- the correlation op ---------------------------------------------------

CORR_GRID = [
    (d, s2, k, s1, mult)
    for d in (0, 1, 2, 4) for s2 in (1, 2) for k in (1, 3) for s1 in (1, 2) for mult in (True, False)
]


@functools.lru_cache(maxsize=None)
def _jax_corr(d, k, s1, s2, mult):
    return jax.jit(partial(
        jax_correlation, max_displacement=d, kernel_size=k, stride1=s1, stride2=s2, is_multiply=mult
    ))


def _corr_inputs(seed, shape=(2, 7, 6, 3)):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize(
    "d,stride2,kernel_size,stride1,multiply", CORR_GRID,
    ids=[f"d{d}-s2_{s2}-k{k}-s1_{s1}-{'mul' if m else 'sub'}" for d, s2, k, s1, m in CORR_GRID],
)
def test_correlation_plain_matches_xla(d, stride2, kernel_size, stride1, multiply):
    f1, f2 = _corr_inputs(d * 7 + stride2)
    ours = correlation_plain(
        torch.from_numpy(f1), torch.from_numpy(f2), d, kernel_size, stride1, stride2, multiply
    )
    ref = np.asarray(_jax_corr(d, kernel_size, stride1, stride2, multiply)(f1, f2))
    assert ours.shape == ref.shape
    assert ours.shape[-1] == num_corr_channels(d, stride2)
    np.testing.assert_allclose(ours.numpy(), ref, **CORR_TOL)
    # on a CPU tensor the dispatching op is the plain version
    disp = correlation(torch.from_numpy(f1), torch.from_numpy(f2), d, kernel_size, stride1, stride2, multiply)
    assert torch.equal(disp, ours)


PALLAS_GRID = [(d, s2) for d in (0, 1, 2, 4) for s2 in (1, 2)]


@pytest.mark.parametrize("d,stride2", PALLAS_GRID, ids=[f"d{d}-s2_{s}" for d, s in PALLAS_GRID])
def test_correlation_plain_matches_pallas_kernel(d, stride2):
    """The k=1 cases against the TPU kernel in interpret mode, at a shape
    that fits no row tile (13 rows in tiles of 4)."""
    f1, f2 = _corr_inputs(40 + d + stride2, shape=(2, 13, 11, 8))
    ref = np.asarray(correlation_pallas(
        jnp.asarray(f1), jnp.asarray(f2), d, stride2=stride2, row_tile=4, interpret=True
    ))
    ours = correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), d, 1, 1, stride2)
    np.testing.assert_allclose(ours.numpy(), ref, **CORR_TOL)


# --- temporal layers ------------------------------------------------------

@pytest.mark.parametrize("keep", ["all", "mid", "none"])
@pytest.mark.parametrize("comp_mid", [False, True])
def test_corr_layer(keep, comp_mid):
    """Corr over a (B, 3, H, W, C) window in each keep mode, with kernel 1
    (the kernel's configuration) and kernel 3 (YOLOv3Temporal's); bf16 in,
    float32 out, as in JAX."""
    x = np.random.RandomState(50).randn(2, K, 7, 6, 5).astype(np.float32)
    for kernel_size in (1, 3):
        jm = jlayers.Corr(2, K, kernel_size=kernel_size, stride=1, keep=keep, comp_mid=comp_mid)
        ref = np.asarray(jax.jit(partial(jm.apply, {}))(x))
        tm = layers.Corr(2, K, kernel_size=kernel_size, stride=1, keep=keep, comp_mid=comp_mid)
        ours = tm(torch.from_numpy(x))
        assert ours.dtype == torch.float32 and ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), ref, **CORR_TOL)
    n = K if comp_mid else K - 1
    want = {"all": (2, 7, 6, K * 5 + n * 25), "mid": (2, 7, 6, 5 + n * 25), "none": (2, n, 7, 6, 25)}
    assert tuple(ours.shape) == want[keep]
    # the time fold puts frame t's channel c at t*C + c
    if keep == "all":
        np.testing.assert_array_equal(ours[..., 5:10].numpy(), x[:, 1])
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert tm(bf).dtype == torch.float32


POOLS = [("max", None, None, 0), ("mean", None, None, 0), ("max", 2, 1, 1), ("mean", 3, 2, 1),
         ("max", 2, None, 0)]


@pytest.mark.parametrize("type_,pool_size,strides,padding", POOLS,
                         ids=["max", "mean", "max-w2-s1-p1", "mean-w3-s2-p1", "max-w2"])
def test_temporal_pooling(type_, pool_size, strides, padding):
    x = np.random.RandomState(51).randn(2, 5, 3, 4, 6).astype(np.float32)
    jm = jlayers.TemporalPooling(type=type_, pool_size=pool_size, strides=strides, padding=padding)
    ref = np.asarray(jm.apply({}, jnp.asarray(x)))
    tm = layers.TemporalPooling(type=type_, pool_size=pool_size, strides=strides, padding=padding)
    ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="max"):
        layers.TemporalPooling(type=None)


def test_time_distributed():
    """A conv cell over each frame of a window, and a tuple-valued call."""
    x = np.random.RandomState(52).randn(2, K, 6, 5, 4).astype(np.float32)
    jm = jlayers.ConvBNLeaky(8, kernel=3)
    v = random_variables(jm, x[:, 0], seed=53)
    ref = jlayers.time_distributed(lambda z: jm.apply(v, z, train=False), jnp.asarray(x))
    tm = layers.ConvBNLeaky(4, 8, kernel=3)
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    tm.eval()
    with torch.no_grad():
        ours = layers.time_distributed(lambda z: tm(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
                                       torch.from_numpy(x))
    assert ours.shape == (2, K, 6, 5, 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    pair = layers.time_distributed(lambda z: (z, 2 * z[..., :1]), torch.from_numpy(x))
    jpair = jlayers.time_distributed(lambda z: (z, 2 * z[..., :1]), jnp.asarray(x))
    for a, r in zip(pair, jpair):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_darknet53_stage1():
    x = np.random.RandomState(54).randn(2, 64, 64, 3).astype(np.float32)
    jm = jdarknet.Darknet53Stage1()
    v = random_variables(jm, x, seed=55, gain=0.5)
    tm = darknet.Darknet53Stage1()
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        ours = tm.eval()(torch.from_numpy(x))
    ref = jax.jit(partial(jm.apply, train=False))(v, x)
    assert ours.shape == ref.shape == (2, 8, 8, 256)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


# --- YOLOv3T --------------------------------------------------------------

MODELS = {
    # the slice's configuration (the factory's, d=4)
    "early-corr": dict(k_join_type="max", k_join_pos="late", corr_pos="early", corr_d=4),
    # the streaming suite's late correlation (tests/test_streaming.py:73)
    "late-corr": dict(corr_pos="late", corr_d=2),
    "late-max": dict(k_join_type="max", k_join_pos="late"),
    # objectness in place of class scores
    "late-mean-agnostic": dict(k_join_type="mean", k_join_pos="late", agnostic=True),
}


def _windows(seed, b=1, size=SIZE):
    return np.random.RandomState(seed).randint(0, 256, (b, K, size, size, 3)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """(variables, uint8 windows, JAX outputs: boxes, scores, ids, sc, bb,
    candidates) of YOLOv3T(20 classes, k=3, MODELS[name]) at 128 px, B=1.
    Kernel gain 0.5 keeps the random activations in range."""
    jm = JaxYOLOv3T(num_classes=20, k=K, **MODELS[name])
    windows = _windows(60)
    x = jax_to_normalized(windows)
    v = random_variables(jm, x, seed=61, gain=0.5)

    @jax.jit
    def step(v, x):
        boxes, scores = jm.apply(v, x, train=False)
        ids, sc, bb = jax_postprocess(boxes, scores, nms_thresh=0.45, nms_topk=400)
        return boxes, scores, ids, sc, bb.clip(0, SIZE), jax_select(boxes, scores)

    return v, windows, tuple(np.asarray(a) for a in step(v, x))


@pytest.mark.parametrize("name", list(MODELS))
def test_yolov3t_full_width(name):
    v, windows, (rb, rsc, *_) = _jax_model(name)
    tm = YOLOv3T(num_classes=20, k=K, **MODELS[name])
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        boxes, scores = tm.eval()(torch.from_numpy(np.asarray(jax_to_normalized(windows))))
    n = 3 * sum((SIZE // s) ** 2 for s in (8, 16, 32))
    classes = 1 if MODELS[name].get("agnostic") else 20
    assert boxes.shape == rb.shape == (1, n, 4) and scores.shape == rsc.shape == (1, n, classes)
    assert np.isfinite(boxes.numpy()).all()
    np.testing.assert_allclose(boxes.numpy(), rb, **TOL)
    np.testing.assert_allclose(scores.numpy(), rsc, **TOL)


FACTORY = {
    # the reference's quirk: the default early join pre-empts the early corr
    "quirk": dict(k=3, corr_pos="early", corr_d=2),
    "slice": dict(k=3, k_join_pos="late", corr_pos="early", corr_d=4),
    # and the default late max join pre-empts the late corr
    "late-quirk": dict(k=3, k_join_pos="late", corr_pos="late", corr_d=2),
    "early-cat": dict(k=3, k_join_type="cat"),
    "late-mean": dict(k=3, k_join_type="mean", k_join_pos="late"),
}


@pytest.mark.parametrize("name", list(FACTORY))
def test_factory_param_shapes(name):
    """Port and JAX factories build the same parameters for a config, leaf
    for leaf (through the bridge).  In the quirk configs the factory's
    default join pre-empts the correlation, which then never runs: block0
    and the output convs take the joined channels in both packages."""
    cfg = FACTORY[name]
    jm = jax_build_model(JaxYoloConfig(num_classes=20, **cfg))
    x = jnp.zeros((1, 3, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), x)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = {k: tuple(v.shape) for k, v in flax_to_state_dict(zeros).items()}
    tm = build_model(YoloConfig(num_classes=20, **cfg))
    ours = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert ours == ref
    cin = ours["block0._TCell_0.ConvBNLeaky_0.Conv_0.weight"][1]
    tip = ours["output0.prediction.weight"][1]
    assert (cin, tip) == {"quirk": (1024, 1024), "slice": (3234, 1024), "late-quirk": (1024, 1024),
                          "early-cat": (3072, 1024), "late-mean": (1024, 1024)}[name]
    assert isinstance(tm, YOLOv3T) and (tm.corr is not None) == ("corr_pos" in cfg)


def test_factory_raises_on_unported_axes():
    for cfg in (
        dict(rnn_pos="late", k_join_pos="late"),
        dict(block_conv_type="3", k_join_pos="late"),
    ):
        with pytest.raises(NotImplementedError, match="slice 5"):
            build_model(YoloConfig(num_classes=2, k=3, **cfg))
    with pytest.raises(NotImplementedError, match="item 9a"):
        YOLOv3T(num_classes=2, k=3, quant=True)
    with pytest.raises(NotImplementedError, match="slice 5"):
        YOLOv3T(num_classes=2, k=3, feed="tips")
    with pytest.raises(ValueError, match="corr_d"):
        YOLOv3T(num_classes=2, k=3, corr_pos="early")
    with pytest.raises(ValueError, match="k_join_type"):
        YOLOv3T(num_classes=2, k=3, k_join_type="sum")


def test_slice_detector_matches_jax():
    """The slice end to end: `Detector` on uint8 windows against the JAX
    apply + postprocess, detections compared as sets for rows scored 1e-3
    clear of the K-th candidate and of the valid threshold (as
    tests/test_torch_serving.py does)."""
    v, windows, (_, _, rids, rsc, rbb, cands) = _jax_model("early-corr")
    cfg = YoloConfig(num_classes=20, k=K, k_join_pos="late", corr_pos="early", corr_d=4)
    det = Detector(cfg, v, data_shape=SIZE, device="cpu")
    ids, sc, bb = (a.numpy() for a in det(windows))
    assert ids.shape == rids.shape == (1, 100, 1) and bb.shape == (1, 100, 4)
    assert bb.min() >= 0 and bb.max() <= SIZE
    floor = max(cands[0, -1, 1], 0.01) + 1e-3
    pick = lambda i, s, x: [  # noqa: E731
        (int(c), np.concatenate([[p], q])) for c, p, q in zip(i.ravel(), s.ravel(), x)
        if c >= 0 and p >= floor
    ]
    ours, ref = pick(ids[0], sc[0], bb[0]), pick(rids[0], rsc[0], rbb[0])
    assert len(ours) == len(ref) > 0
    unused = list(range(len(ref)))
    for c, row in ours:
        hit = next(u for u in unused if ref[u][0] == c and np.abs(ref[u][1] - row).max() < 1e-3)
        unused.remove(hit)
    with pytest.raises(ValueError, match="expected images"):
        det(windows[:, 0])


def test_detect_temporal_flags_on_cpu(capsys):
    preds = detect.main([
        "--data_shape", "64", "--batch_size", "2", "--num_requests", "1", "--device", "cpu",
        "--dtype", "f32", "--window", "3,2", "--k_join_pos", "late", "--corr_pos", "early",
        "--corr_d", "2",
    ])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("request")]
    assert len(lines) == 1 and "/window" in lines[0]
    assert sorted(preds) == ["request0/window0000", "request0/window0001"]
    for entries in preds.values():
        assert all(len(e) == 6 and 0 <= min(e[2:]) and max(e[2:]) <= 1 for e in entries)
    # window i takes every stride-th frame of a clip from frame i
    (batch,) = detect._requests(np.random.RandomState(0), 1, 3, 8, 3, 2)
    assert batch.shape == (3, 3, 8, 8, 3)
    np.testing.assert_array_equal(batch[0, 1:], batch[2, :2])
    assert not np.array_equal(batch[0], batch[1])
