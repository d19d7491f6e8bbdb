"""The two-stream R(2+1)D family (ROADMAP.md Queue 1 item 7, its R(2+1)D
half) against the JAX package on the CPU: `_mid_channels`, R(2+1)D's
frozen BN (eps 1e-3), `R21D` with basic and bottleneck blocks in its three
output modes (taps, pooled features, the classifier), the full-width
`r21d_34` on windows of 9 and 33, `r21d_152`'s tree, the VMZ `.pkl`
importer, `TwoStreamDarknet(stream="r21d")` ungated and gated by "mul",
the factory's two-stream YOLOv3T gated by "add" (its detections, the top-k
and plain NMS), one float64 train step (R21D's statistics left alone, its
parameters decayed), the bridge and flax msgpack both ways, and the
refusals beside the JAX package's behaviour.

Inputs are numpy arrays from a seed, the flax variables random
(tests/test_torch_rnn.py's `fill_random`) and carried across by the bridge.
Tolerances: in float64 every output within 1e-9 of each tensor's largest
magnitude; BN within 1e-12; detections within tests/test_torch_streaming.py's
1e-4; the top-k and NMS on the same candidates exact; the float64 train
step's losses within rtol 1e-6 and its gradients within 1e-5 (both
packages decode and take the loss in float32); the importer and the
frozen statistics bit for bit."""
import os
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_r21d_import import _synth_vmz
from test_torch_backbones import LR, _GradState, _check_stats, _close64, _train_batch
from test_torch_flownet import _jax64, _jax_variables, _load, _x
from test_torch_rnn import NC, S, fill_random
from test_torch_streaming import assert_dets_close
from videoyolo_tpu.models import r21d as jr21d
from videoyolo_tpu.models import ts_darknet as jts
from videoyolo_tpu.models.factory import YoloConfig as JaxYoloConfig
from videoyolo_tpu.models.factory import build_model as jax_build_model
from videoyolo_tpu.models.yolo3 import postprocess_tout as jax_postprocess_tout
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.train import lr as jlr
from videoyolo_tpu.train import step as jstep
from videoyolo_tpu.utils.r21d_import import load_vmz_r21d as jax_load_vmz
from videoyolo_torch.models import layers, r21d, ts_darknet
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.yolo3 import postprocess_tout
from videoyolo_torch.models.yolo3_temporal import YOLOv3T
from videoyolo_torch.streaming import StreamingDetector
from videoyolo_torch.train import checkpoint, lr, step
from videoyolo_torch.utils.flax_bridge import _LEAVES, flax_to_state_dict, walk
from videoyolo_torch.utils.r21d_import import load_vmz_r21d
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)
from torch_heap import trim_heap

torch.set_num_threads(2)

CH = (16, 8, 4)  # narrow FPN channels for the train step
NARROW = {  # block: (blocks a stage, channels), channels divisible by 4 for the bottleneck
    "basic": ((1, 2, 1, 1), (8, 8, 16, 32, 64)),
    "bottleneck": ((1, 1, 2, 1), (8, 16, 32, 64, 128)),
}


def _without_dense(variables):
    return {"params": {k: p for k, p in variables["params"].items() if k != "dense"},
            "batch_stats": variables["batch_stats"]}


def _all_modes(kw):
    """One jitted float64 apply of the JAX R21D in its three output modes
    (the classifier's variables; the other modes without `dense`)."""
    taps, feats, cls = (jr21d.R21D(return_taps=True, **kw), jr21d.R21D(return_features=True, **kw), jr21d.R21D(**kw))

    def fn(v, x):
        return (taps.apply(_without_dense(v), x), feats.apply(_without_dense(v), x), cls.apply(v, x))

    return fn


def _port_all_modes(tm, x):
    """The port's R21D in its three output modes on `x` (float64); `tm`
    holds `dense`."""
    outs = []
    with torch.no_grad():
        for taps, feats in ((True, False), (False, True), (False, False)):
            tm.return_taps, tm.return_features = taps, feats
            outs.append(tm(torch.from_numpy(x.astype(np.float64))))
    tm.return_taps = tm.return_features = False
    return outs


def _check_all_modes(got, ref, what):
    (taps, feats, (y, pooled, probs)), (rtaps, rfeats, (ry, rpooled, rprobs)) = got, ref
    for i, (a, b) in enumerate(zip(taps, rtaps)):
        _close64(a.numpy(), b, f"{what} tap {i + 1}")
    for i, (a, b) in enumerate(zip(feats, rfeats)):
        _close64(a.numpy(), b, f"{what} pooled feature {i + 2}")
    for name, a, b in (("features", y, ry), ("pooled", pooled, rpooled), ("softmax", probs, rprobs)):
        _close64(a.numpy(), b, f"{what} classifier {name}")


# --- the cells ------------------------------------------------------------------

@pytest.mark.parametrize("kernel, cin, cout, mid", [
    ((3, 3, 3), 64, 64, 144), ((3, 3, 3), 64, 128, 230), ((3, 3, 3), 128, 128, 288), ((3, 3, 3), 256, 256, 576),
    ((3, 3, 3), 512, 512, 1152), ((3, 3, 3), 128, 256, 460), ((3, 7, 7), 3, 64, 83), ((3, 3, 3), 16, 16, 36),
])
def test_mid_channels_match_jax(kernel, cin, cout, mid):
    """The factored conv's mid count equals the JAX package's and the
    table's (R(2+1)D-34's cells: 144, 230, 288, 576, 1152)."""
    assert r21d._mid_channels(kernel, cin, cout) == jr21d._mid_channels(kernel, cin, cout) == mid


@pytest.mark.parametrize("layout", ["contiguous", "channels_last_3d"])
def test_frozen_batchnorm_eps_matches_flax(layout):
    """`layers.BatchNorm(eps=1e-3)` on NCDHW (B, C, T, H, W) in float64,
    contiguous or in `channels_last_3d` memory, in eval mode equals flax's
    `BatchNorm(use_running_average=True, epsilon=1e-3)` on the NTHWC
    tensor within 1e-12; the default eps stays 1e-5.  An `R21D` in train
    mode keeps every BN in eval: the output equals eval mode's bit for bit
    and no running statistic moves."""
    x = np.random.RandomState(1).randn(2, 3, 4, 5, 6)  # NTHWC, C=6
    rs = np.random.RandomState(2)
    scale, bias, mean = rs.randn(6), rs.randn(6), rs.randn(6)
    var = rs.uniform(0.5, 1.5, 6)
    with jax.enable_x64(True):
        ref = np.asarray(fnn.BatchNorm(use_running_average=True, epsilon=1e-3).apply(
            {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}, jnp.asarray(x)))
    bn = layers.BatchNorm(6, eps=1e-3).double().eval()
    assert layers.BatchNorm(6).eps == layers.BN_EPS == 1e-5 and bn.eps == r21d.BN_EPS_R21D == 1e-3
    for name, a in (("weight", scale), ("bias", bias), ("running_mean", mean), ("running_var", var)):
        getattr(bn, name).data.copy_(torch.from_numpy(a))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    if layout == "channels_last_3d":
        xt = xt.contiguous(memory_format=torch.channels_last_3d)
    else:
        xt = xt.contiguous()
    got = bn(xt).permute(0, 2, 3, 4, 1).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)

    tm = r21d.R21D(block="basic", layers=(1, 1, 1, 1), channels=(8, 8, 16, 32, 64), return_taps=True,
                   dtype=torch.float64).double()
    layers.init_weights(tm, torch.Generator().manual_seed(3))
    for m in tm.modules():
        if isinstance(m, layers.BatchNorm):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 1.5)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    xw = torch.from_numpy(np.random.RandomState(4).randn(2, 4, 16, 16, 3))
    want = tm.eval()(xw)
    tm.train()
    assert tm.training and not any(m.training for m in tm.modules() if isinstance(m, layers.BatchNorm))
    got = tm(xw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(t, before[k]) for k, t in tm.state_dict().items())


# --- R21D --------------------------------------------------------------------------

@pytest.mark.parametrize("block", sorted(NARROW))
def test_r21d_blocks_match_flax_float64(block):
    """A narrow `R21D` of each block type on (2, 4, 32, 32, 3) windows: its
    tree is flax's leaf for leaf; the four taps, the three pooled features
    and the classifier's (features, pooled, softmax) within 1e-9 of flax's
    in float64, in eval and in train mode (frozen BN)."""
    n, ch = NARROW[block]
    kw = dict(block=block, layers=n, channels=ch, classes=5)
    x = _x((2, 4, 32, 32, 3), 6)
    v = _jax_variables(jr21d.R21D(**kw), x, 6)
    ref = _jax64(_all_modes(kw), v, x)
    tm = r21d.R21D(dtype=torch.float64, **kw).double()
    assert set(tm.state_dict()) == set(flax_to_state_dict(v))
    _load(tm, v, torch.float64)
    for mode in (False, True):
        _check_all_modes(_port_all_modes(tm.train(mode), x), ref, f"{block} train={mode}")
    assert [tuple(t.shape) for t in ref[0]] == [(2, 4, 16, 16, ch[1]), (2, 2, 8, 8, ch[2]), (2, 1, 4, 4, ch[3]),
                                                (2, 1, 2, 2, ch[4])]


R21D34_S = 64


@pytest.fixture(scope="module")
def r21d34():
    """R(2+1)D-34's flax template (classifier, 400 classes) from
    `eval_shape`, and one jitted float64 apply of its taps and classifier."""
    jm, taps = jr21d.r21d_34(), jr21d.r21d_34(return_taps=True)
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 9, R21D34_S, R21D34_S, 3)))

    @jax.jit
    def apply(v, x):
        return taps.apply(_without_dense(v), x), jm.apply(v, x)

    return shapes, apply


@pytest.mark.parametrize("t", [9, 33])
def test_r21d34_full_width_matches_flax_float64(t, r21d34):
    """`r21d_34` at full width on a (1, t, 64, 64, 3) window in float64: the
    four taps (time 9 -> 9, 5, 3, 2 or 33 -> 33, 17, 9, 5) within 1e-9 of
    flax's, and at t=9 the classifier's outputs too."""
    shapes, apply = r21d34
    v = fill_random(shapes, 7)
    x = _x((1, t, R21D34_S, R21D34_S, 3), 7)
    tm = _load(r21d.r21d_34(dtype=torch.float64).double(), v, torch.float64).train()
    with torch.no_grad():
        got = tm.taps(torch.from_numpy(x.astype(np.float64)).permute(0, 4, 1, 2, 3))
        cls = tm(torch.from_numpy(x.astype(np.float64))) if t == 9 else None
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        rtaps, rcls = jax.tree_util.tree_map(np.asarray, apply(v64, jnp.asarray(x, np.float64)))
    times = (t, 5, 3, 2) if t == 9 else (t, 17, 9, 5)
    assert [tuple(r.shape) for r in rtaps] == [(1, tt, R21D34_S // s, R21D34_S // s, c) for tt, s, c in zip(
        times, (2, 4, 8, 16), (64, 128, 256, 512))]
    for i, (a, b) in enumerate(zip(got, rtaps)):
        _close64(a.permute(0, 2, 3, 4, 1).numpy(), b, f"t={t} tap {i + 1}")
    if cls is not None:
        for name, a, b in zip(("features", "pooled", "softmax"), cls, rcls):
            _close64(a.numpy(), b, f"classifier {name}")


# --- the VMZ importer -------------------------------------------------------------------

def test_vmz_import_34_matches_jax(r21d34, tmp_path):
    """A VMZ `.pkl` written from R(2+1)D-34's tree: the port's importer gives
    JAX's importer's variables through the bridge, leaf for leaf, bit for
    bit (`riv` as it is; stage 2's projection from shortcut_projection_3;
    the classifier); the loaded models' outputs agree within 1e-9 in
    float64.  Into a `TwoStreamDarknet`'s `r21d` (no `dense`): the same
    leaves but the classifier.  Both importers raise KeyError on a missing
    blob and refuse a wrong shape (JAX AssertionError, the port
    ValueError)."""
    shapes, apply = r21d34
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    path = str(tmp_path / "r21d_34.pkl")
    blobs = _synth_vmz(v, path)
    want = flax_to_state_dict(jax_load_vmz(v, path, 34))
    tm = r21d.r21d_34(dtype=torch.float64).double()
    assert load_vmz_r21d(tm, path, 34) is tm
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert torch.equal(got[key], w.to(got[key].dtype)), key
    assert np.array_equal(tm.init_bn.running_var.numpy(), blobs["conv1_spatbn_relu_riv"])
    assert np.array_equal(tm.stage2_block1.down.weight.detach().numpy(), blobs["shortcut_projection_3_w"])
    assert np.array_equal(tm.dense.weight.detach().numpy(), blobs["last_out_L400_w"])
    x = _x((1, 9, R21D34_S, R21D34_S, 3), 8)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x.astype(np.float64)))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax_load_vmz(v, path, 34))
        ref = jax.tree_util.tree_map(np.asarray, apply(v64, jnp.asarray(x, np.float64)))[1]
    for name, a, b in zip(("features", "pooled", "softmax"), out, ref):
        _close64(a.numpy(), b, f"loaded classifier {name}")

    with torch.device("meta"):
        ts = ts_darknet.TwoStreamDarknet(stream="r21d", t=9)
    ts = ts.to_empty(device="cpu")
    assert load_vmz_r21d(ts, path, 34) is ts
    inner = ts.r21d.state_dict()
    assert inner.keys() == {k for k in want if not k.startswith("dense.")}
    assert all(torch.equal(t, want[k]) for k, t in inner.items() if not k.endswith("num_batches_tracked"))

    with open(path, "wb") as f:
        pickle.dump({"blobs": {k: b for k, b in blobs.items() if k != "comp_5_spatbn_2_rm"}}, f)
    for load, model in ((jax_load_vmz, v), (load_vmz_r21d, tm)):
        with pytest.raises(KeyError):
            load(model, path, 34)
    blobs["comp_5_conv_2_w"] = blobs["comp_5_conv_2_w"][:, :-1]
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    with pytest.raises(AssertionError):
        jax_load_vmz(v, path, 34)
    with pytest.raises(ValueError, match="stage2_block3.conv2.temporal.weight"):
        load_vmz_r21d(tm, path, 34)
    with pytest.raises(ValueError, match="34 and 152"):
        load_vmz_r21d(tm, path, 50)
    os.remove(path)


def test_r21d152_tree_and_import_beside_jax(tmp_path):
    """`r21d_152`'s tree (bottleneck blocks, 3/8/36/3) is flax's from
    `eval_shape`: every leaf under the bridge's names and layouts, shape for
    shape.  JAX's importer fails on it with a KeyError (it walks
    conv1/spatial, and a bottleneck block's conv1 is a 1x1x1 conv); the
    port's refuses it with that reason."""
    shapes = jax.eval_shape(partial(jr21d.r21d_152().init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 32, 32, 3)))
    with torch.device("meta"):
        tm = r21d.r21d_152()
    ours = {k: tuple(t.shape) for k, t in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    want = {}
    for coll, names in _LEAVES.items():
        for path, sds in jax.tree_util.tree_flatten_with_path(shapes[coll])[0]:
            *mods, leaf = (p.key for p in path)
            s = tuple(sds.shape)
            want[".".join(mods + [names[leaf]])] = {5: lambda: (s[4], s[3], *s[:3]), 2: lambda: s[::-1]}.get(
                len(s) if leaf == "kernel" else 0, lambda: s)()
    assert ours == want
    assert ours["stage3_block36.conv2.spatial.weight"] == (576, 256, 1, 3, 3) and ours["dense.weight"] == (400, 2048)

    def zeros(tree):
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)

    # the init's leaves as arrays (JAX's importer loads them first), the
    # rest the template's shapes
    v = {c: {**shapes[c], "init": zeros(shapes[c]["init"]), "init_bn": zeros(shapes[c]["init_bn"])}
         for c in ("params", "batch_stats")}
    blobs = {"conv1_middle_w": np.ones((45, 3, 1, 7, 7), np.float32), "conv1_w": np.ones((64, 45, 3, 1, 1), np.float32),
             "comp_0_conv_1_middle_w": np.ones((144, 64, 1, 3, 3), np.float32)}
    for prefix, c in (("conv1_middle_spatbn_relu", 45), ("conv1_spatbn_relu", 64)):
        blobs.update({f"{prefix}_{s}": np.ones(c, np.float32) for s in ("s", "b", "rm", "riv")})
    path = str(tmp_path / "r21d_152.pkl")
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    with pytest.raises(KeyError, match="spatial"):
        jax_load_vmz(v, path, 152)
    with pytest.raises(ValueError, match="bottleneck block's conv1 is a 1x1x1 conv"):
        load_vmz_r21d(tm, path, 152)


# --- the two-stream backbone ---------------------------------------------------------

@pytest.mark.parametrize("add_type", [None, "mul"], ids=["ungated", "mul"])
def test_two_stream_r21d_backbone_matches_flax_float64(add_type):
    """`TwoStreamDarknet(stream="r21d", t=9)` on a (1, 9, 64, 64, 3) window:
    its tree is flax's (`r21d`, and `conv0`, `stage1-5` or `gstart`,
    `gstage4`, `stage5`), the three routes (256 + 128, 512 + 256, 1024 + 512
    channels) within 1e-9 in float64."""
    x = _x((1, 9, S, S, 3), 5)
    jm = jts.TwoStreamDarknet(stream="r21d", t=9, add_type=add_type)
    v = _jax_variables(jm, x, 5)
    assert sorted(v["params"]) == (["conv0", "r21d"] + [f"stage{i}" for i in range(1, 6)] if add_type is None
                                   else ["gstage4", "gstart", "r21d", "stage5"])
    ref = _jax64(lambda v, x: jm.apply(v, x, train=False), v, x)
    tm = _load(ts_darknet.TwoStreamDarknet(stream="r21d", t=9, add_type=add_type, dtype=torch.float64).double(), v,
               torch.float64).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x.astype(np.float64)))
    assert [tuple(r.shape) for r in got] == [(1, S // 8, S // 8, 384), (1, S // 16, S // 16, 768),
                                            (1, S // 32, S // 32, 1536)]
    assert tuple(tm.route_channels) == (384, 768, 1536)
    for i, (a, b) in enumerate(zip(got, ref)):
        _close64(a.numpy(), b, f"{add_type} route {i}")


# --- the factory's two-stream detector -------------------------------------------------

FACTORY = dict(k=9, motion_stream="r21d", add_type="add")


def test_factory_r21d_detector_matches_jax():
    """`build_model(motion_stream="r21d", k=9, add_type="add")` (full
    widths, 3 classes) is YOLOv3T over `TwoStreamDarknet`: its parameter
    tree is JAX's, and at k=33 too; in float32 its detections within 1e-4
    of JAX's postprocess, and the port's top-k and plain NMS on JAX's
    decoded outputs exactly JAX's."""
    jm = jax_build_model(JaxYoloConfig(num_classes=NC, **FACTORY))
    x = _x((1, 9, S, S, 3), 9)
    v = _jax_variables(jm, x, 9)
    tm = build_model(YoloConfig(num_classes=NC, **FACTORY))
    assert isinstance(tm, YOLOv3T) and isinstance(tm.backbone, ts_darknet.TwoStreamDarknet) and tm.k == 9
    assert tm.backbone.stream == "r21d" and tm.backbone.add_type == "add"
    assert not (tm.early_join or tm.early_corr or tm.late_join or tm.late_corr)
    assert set(tm.state_dict()) == set(flax_to_state_dict(v))
    _load(tm, v).eval()
    with torch.no_grad():
        boxes, scores = tm(torch.from_numpy(x))
    del tm
    rboxes, rscores = jax.jit(partial(jm.apply, train=False))(v, jnp.asarray(x))
    ref_dets = jax.device_get(jax_postprocess_tout(rboxes, rscores))
    assert_dets_close(postprocess_tout(boxes, scores), ref_dets)
    exact = postprocess_tout(torch.from_numpy(np.asarray(rboxes)), torch.from_numpy(np.asarray(rscores)))
    for a, b in zip(exact, ref_dets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((exact[0] >= 0).sum()) > 0
    jax.clear_caches()
    k33 = dict(FACTORY, k=33, add_type=None)
    shapes = jax.eval_shape(partial(jax_build_model(JaxYoloConfig(num_classes=NC, **k33)).init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 33, S, S, 3)))
    with torch.device("meta"):
        t33 = build_model(YoloConfig(num_classes=NC, **k33))
    want = {}
    for coll, names in _LEAVES.items():
        for path, _ in jax.tree_util.tree_flatten_with_path(shapes[coll])[0]:
            *mods, leaf = (p.key for p in path)
            want[".".join(mods + [names[leaf]])] = None
    assert {k for k in t33.state_dict() if not k.endswith("num_batches_tracked")} == set(want)
    assert t33.k == 33 and t33.backbone.t == 33


# --- one float64 train step ------------------------------------------------------------

@pytest.fixture(scope="module")
def train_models():
    """(JAX's YOLOv3T over the "add" R(2+1)D two-stream backbone with the
    narrow FPN, its random variables, the port's float64 model on them)."""
    jm = JaxYOLOv3T(num_classes=NC, k=9, channels=CH, backbone=jts.TwoStreamDarknet(stream="r21d", t=9,
                                                                                      add_type="add"))
    v = _jax_variables(jm, np.zeros((1, 9, S, S, 3), np.float32), 10)
    tm = YOLOv3T(num_classes=NC, k=9, channels=CH, dtype=torch.float64,
                 backbone=ts_darknet.TwoStreamDarknet(stream="r21d", t=9, add_type="add", dtype=torch.float64)).double()
    return jm, v, _load(tm, v, torch.float64)


def test_train_step_float64_matches_jax(train_models):
    """One float64 train step (B=2 windows of 9, normalised pixels, the
    targets and the loss) against JAX's jitted step: the losses within rtol
    1e-6; every parameter's gradient within 1e-5 of its largest magnitude,
    R(2+1)D's among them; darknet's running statistics within 1e-9 and
    R(2+1)D's unchanged, bit for bit, on both sides.  The update is SGD's
    with coupled decay, optax's: every R(2+1)D parameter moves by lr (g + wd
    p)."""
    jm, variables, tm = train_models
    batch = _train_batch(9, 10)
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx = jstep.make_optimizer(jlr.lr_schedule(**LR))
        state = _GradState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                           opt_state=tx.init(v["params"]), tx=tx)
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        fn = jax.jit(jstep.make_train_step(jm, num_classes=NC)).lower(state, jb).compile(
            compiler_options={"xla_backend_optimization_level": 1})
        state, jmetrics = fn(state, jb)
        grads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, state.params)})
        stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)})
        jmetrics = {k: float(m) for k, m in jmetrics.items()}
    del state, v, fn
    jax.clear_caches()
    trim_heap()
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    old = flax_to_state_dict(variables)
    r21d_stats = [k for k in old if k.startswith("backbone.r21d.") and ("running_" in k)]
    assert len(r21d_stats) == 2 * 69  # the init's 2 BNs, 16 blocks' 4, 3 projections'
    for k in r21d_stats:
        assert torch.equal(stats[k], old[k]), k
    tm.zero_grad(set_to_none=True)
    schedule = lr.lr_schedule(**LR)
    metrics = step.make_train_step(tm, num_classes=NC)(step.create_train_state(tm, schedule),
                                                       {k: torch.from_numpy(a) for k, a in batch.items()})
    for k, m in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), m, rtol=1e-6, err_msg=k)
    params = dict(tm.named_parameters())
    assert set(params) == {k for k in grads if not k.endswith("num_batches_tracked")}
    for k, g in grads.items():
        if k in params:
            err = float((params[k].grad - g).abs().max())
            assert err <= 1e-5 * max(float(g.abs().max()), 1e-30), (k, err)
    assert float(params["backbone.r21d.init.spatial.weight"].grad.abs().max()) > 0
    assert float(params["backbone.r21d.stage4_block3.bn2.weight"].grad.abs().max()) > 0
    now = tm.state_dict()
    for k in r21d_stats:
        assert torch.equal(now[k], before[k]), k
    _check_stats(tm, {k: s for k, s in stats.items() if k not in r21d_stats})
    rate = float(schedule(0))
    for k, p in params.items():
        if k.startswith("backbone.r21d."):
            want = before[k] - rate * (p.grad + 5e-4 * before[k])
            torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-12 * max(float(want.abs().max()), 1.0))
    w = "backbone.r21d.stage3_block2.conv1.temporal.weight"
    assert not torch.allclose(params[w].detach(), before[w] - rate * params[w].grad, rtol=0, atol=1e-12)


def test_bridge_and_msgpack_round_trip(train_models, tmp_path):
    """JAX's variables of the gated R(2+1)D two-stream YOLOv3T -> the bridge
    -> the port (strict) -> back: the same tree leaf for leaf (the 5-D
    kernels, R(2+1)D's statistics); a JAX-written `.params` read by the port
    and the port's read by JAX, equal."""
    _, v, _ = train_models
    tm = _load(YOLOv3T(num_classes=NC, k=9, channels=CH,
                       backbone=ts_darknet.TwoStreamDarknet(stream="r21d", t=9, add_type="add")), v)
    want = dict(walk(v))
    back = dict(walk(checkpoint.variables_of(tm)))
    assert back.keys() == want.keys()
    assert all(np.array_equal(a, want[p]) for p, a in back.items())
    assert want[("params", "backbone", "r21d", "stage2_block1", "conv1", "spatial", "kernel")].shape == (1, 3, 3, 64, 230)
    assert ("batch_stats", "backbone", "r21d", "init", "mid_bn", "var") in want
    path = str(tmp_path / "jax.params")
    jckpt.save_variables(path, v)
    checkpoint.load_into(tm, checkpoint.load_variables(path, checkpoint.variables_of(tm)))
    checkpoint.save_variables(path, checkpoint.variables_of(tm))
    again = jckpt.load_variables(path, jax.tree_util.tree_map(np.zeros_like, v))
    assert all(np.array_equal(np.asarray(a), want[p]) for p, a in walk(dict(again)))
    os.remove(path)


# --- the refusals beside JAX's behaviour -----------------------------------------------------

def test_refusals_beside_jax():
    """A window other than 9 or 33 fails JAX's factory assertion and raises
    ValueError here with its message; an unknown stream raises ValueError;
    the int8 model raises item 9a; the streaming detector refuses the
    two-stream backbone, as JAX's stream asserts; a backbone of another
    class is not built."""
    for k in (3, 5, 17):
        with pytest.raises(AssertionError, match=r"k in \{9,33\}"):
            jax_build_model(JaxYoloConfig(num_classes=NC, k=k, motion_stream="r21d"))
        with pytest.raises(ValueError, match=r"k in \{9,33\}"):
            build_model(YoloConfig(num_classes=NC, k=k, motion_stream="r21d"))
    with pytest.raises(ValueError, match="stream must be"):
        ts_darknet.TwoStreamDarknet(stream="r3d", t=9)
    with pytest.raises(NotImplementedError, match="item 9a"):
        ts_darknet.TwoStreamDarknet(stream="r21d", t=9, quant="fused")
    with pytest.raises(ValueError, match="block must be"):
        r21d.R21D(block="wide")
    with torch.device("meta"):
        model = build_model(YoloConfig(num_classes=NC, **FACTORY))
    with pytest.raises(ValueError, match="built-in per-frame backbone"):
        StreamingDetector(model.eval())
    with pytest.raises(NotImplementedError, match="item 7"):
        YOLOv3T(num_classes=NC, k=9, backbone=torch.nn.Identity())
