"""The 3D / 2+1D and hierarchical DarkNet backbones (ROADMAP.md Queue 1
item 7, the `new_model` family) against the JAX package on the CPU: the
cells (`Conv21DRepPad`, `_Unit` of types 2, 3 and 21, `Darknet3DBasicBlock`)
in eval and train mode, `Darknet3D` and `HDarknet` whole, the 2D -> 3D
inflation, the factory-built YOLOv3T over each backbone (raw heads, then the
decode, top-k and plain NMS), one float64 train step of each backbone (the
loss, every gradient, the running statistics), the weight bridge and the
flax-msgpack checkpoints both ways, and the refusals beside the JAX
package's behaviour.

Inputs are numpy arrays from a seed, the flax variables random
(tests/test_torch_rnn.py's `fill_random`) and carried across by the bridge;
64 px.  Tolerances: the cells in float32 within rtol 1e-4 / atol 1e-5; in
float64 the backbones' routes, the raw heads (the prediction maps) and, in
train mode, every gradient of a projection of them and the statistics
within 1e-9 of each tensor's largest magnitude; detections within
tests/test_torch_streaming.py's 1e-4; the top-k and NMS on the same
candidates exact.  Both packages decode the heads and take the loss in
float32, so the float64 train step's losses and gradients are held at
tests/test_torch_rnn.py's float64 step tolerances (1e-6, 1e-5)."""
import functools
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rnn import NC, S, fill_random
from test_torch_streaming import assert_dets_close
from videoyolo_tpu import streaming as jstreaming
from videoyolo_tpu.models import darknet3d as jdk
from videoyolo_tpu.models import h_darknet as jhd
from videoyolo_tpu.models import inflate as jinflate
from videoyolo_tpu.models.darknet import Darknet53 as JaxDarknet53
from videoyolo_tpu.models.factory import YoloConfig as JaxYoloConfig
from videoyolo_tpu.models.factory import build_model as jax_build_model
from videoyolo_tpu.models.yolo3 import postprocess_tout as jax_postprocess_tout
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.train import lr as jlr
from videoyolo_tpu.train import step as jstep
from videoyolo_torch.models import darknet3d, h_darknet, inflate
from videoyolo_torch.models.factory import YoloConfig, build_model, yolo3_3ddarknet
from videoyolo_torch.models.layers import init_weights
from videoyolo_torch.models.yolo3 import postprocess_tout
from videoyolo_torch.models.yolo3_temporal import YOLOv3T
from videoyolo_torch.streaming import StreamingDetector
from videoyolo_torch.train import checkpoint, lr, step
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict, walk
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)
from torch_heap import trim_heap

torch.set_num_threads(2)

CH = (16, 8, 4)  # narrow FPN channels for the train steps
F64 = 1e-9
CELL_TOL = dict(rtol=1e-4, atol=1e-5)

DARKNET3D = {
    "2-3-3": dict(conv_types=(2, 3, 3, 2, 2, 2)),
    "2-21-21-funnel": dict(conv_types=(2, 21, 21, 2, 2, 2), funnel_time=True),
    "3-all": dict(conv_types=(3, 3, 3, 3, 3, 3)),
    "2-all-window": dict(conv_types=(2, 2, 2, 2, 2, 2)),
}
HDARKNET = {  # name: (windows, merge type, frames)
    "3-max": ((3, 1, 1, 1, 1), "max", 3),
    "3-conv": ((3, 1, 1, 1, 1), "conv", 3),
    "3-3-max": ((3, 3, 1, 1, 1), "max", 9),
    "3-3-conv": ((3, 3, 1, 1, 1), "conv", 9),
}
# the factory's new_model configurations (full widths) and their windows
FACTORY = {
    "darknet3d-2-3-3": (dict(k=5, conv_types=(2, 3, 3, 2, 2, 2)), 5),
    "darknet3d-2-21-21-funnel": (dict(k=5, conv_types=(2, 21, 21, 2, 2, 2), funnel_time=True), 5),
    "hdarknet-3-3-max": (dict(k=9, hierarchical=(3, 3, 1, 1, 1), h_join_type="max"), 9),
    "hdarknet-3-conv": (dict(k=3, hierarchical=(3, 1, 1, 1, 1), h_join_type="conv"), 3),
}


def _x(shape, seed, dtype=np.float32):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


def _jax_variables(jm, x, seed):
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.asarray(x))
    return fill_random(shapes, seed)


def _load(tm, variables, dtype=torch.float32):
    state = flax_to_state_dict(variables)
    tm.load_state_dict({k: t.to(dtype) if t.is_floating_point() else t for k, t in state.items()}, strict=True)
    return tm


def _close64(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= F64 * max(float(np.abs(want).max()), 1e-30), (what, err)


def _f64_apply(jm, variables, x):
    """JAX's eval-mode apply in float64."""
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        out = jax.jit(partial(jm.apply, train=False))(v, jnp.asarray(x, jnp.float64))
        return jax.tree_util.tree_map(np.asarray, out)


# --- the cells ------------------------------------------------------------------

def _cell_check(jm, tm, x, train, seed):
    """A cell's output (and in train mode its running statistics) against
    flax's on random variables, float32."""
    v = _jax_variables(jm, x, seed)
    _load(tm, v).train(train)
    out = tm(torch.from_numpy(x))
    if train:
        ref, mutated = jm.apply(v, x, train=True, mutable=["batch_stats"])
        stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])})
        for key, want in stats.items():
            if not key.endswith("num_batches_tracked"):
                torch.testing.assert_close(tm.state_dict()[key], want.float(), rtol=1e-5, atol=1e-6)
    else:
        ref = jm.apply(v, x, train=False)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **CELL_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw", [dict(kernel=3), dict(kernel=3, stride=(2, 2, 2)), dict(kernel=1), dict(kernel=5)],
                         ids=["k3", "k3-stride2", "k1", "k5-zeros"])
def test_conv21d_rep_pad_matches_flax(kw, train):
    """`Conv21DRepPad`: the (1, k, k) cell, the edge-repeat pad (zeros for k
    other than 3) and the depthwise temporal conv with no bias."""
    x = _x((2, 5, 9, 10, 6), 1)
    tm = darknet3d.Conv21DRepPad(6, 8, **kw)
    assert tm.temporal.weight.shape == (8, 1, kw["kernel"], 1, 1) and tm.temporal.bias is None
    _cell_check(jdk.Conv21DRepPad(8, **kw), tm, x, train, seed=1)


UNITS = {
    "2-image": (dict(kernel=3, conv_type=2, stride=2), (2, 9, 10, 6), "ConvBNLeaky_0"),
    "2-window": (dict(kernel=3, conv_type=2), (2, 5, 9, 10, 6), "ConvBNLeaky_0"),
    "3-stride2": (dict(kernel=3, conv_type=3, stride=2, temp_stride=2), (2, 5, 9, 10, 6), "ConvBNLeaky3D_0"),
    "21-stride2": (dict(kernel=3, conv_type=21, stride=2, temp_stride=2), (2, 5, 9, 10, 6), "Conv21DRepPad_0"),
    "21-k1": (dict(kernel=1, conv_type=21), (2, 5, 9, 10, 6), "ConvBNLeaky3D_0"),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(UNITS))
def test_unit_matches_flax(name, train):
    """`_Unit` of each conv type, its one cell under flax's auto name."""
    kw, shape, cell = UNITS[name]
    x = _x(shape, 2)
    tm = darknet3d._Unit(6, 8, **kw)
    assert [n for n, _ in tm.named_children()] == [cell]
    _cell_check(jdk._Unit(8, **kw), tm, x, train, seed=2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("conv_type", [2, 3, 21])
def test_basic_block_matches_flax(conv_type, train):
    """`Darknet3DBasicBlock`: the reduce (a (1, 1, 1) 3-D cell in a 21
    block), the expand and the residual."""
    x = _x((2, 3, 8, 7, 8), 3)
    tm = darknet3d.Darknet3DBasicBlock(4, conv_type)
    reduce = tm._Unit_0.ConvBNLeaky_0 if conv_type == 2 else tm._Unit_0.ConvBNLeaky3D_0
    assert reduce.Conv_0.weight.shape[2:] == ((1, 1) if conv_type == 2 else (1, 1, 1))
    _cell_check(jdk.Darknet3DBasicBlock(4, conv_type), tm, x, train, seed=3)


# --- the backbones whole ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DARKNET3D))
def test_darknet3d_matches_flax_float64(name):
    """`Darknet3D` on (2, 5, 64, 64, 3) windows: the three routes, time
    max-pooled at the swap point or at the end, within 1e-9 in float64."""
    kw = DARKNET3D[name]
    x = _x((2, 5, S, S, 3), 4)
    jm = jdk.Darknet3D(**kw)
    v = _jax_variables(jm, x, 4)
    ref = _f64_apply(jm, v, x)
    tm = _load(darknet3d.Darknet3D(dtype=torch.float64, **kw).double(), v, torch.float64).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x.astype(np.float64)))
    assert [tuple(r.shape) for r in got] == [(2, S // s, S // s, c) for s, c in ((8, 256), (16, 512), (32, 1024))]
    for i, (a, b) in enumerate(zip(got, ref)):
        _close64(a.numpy(), b, f"{name} route {i}")


@pytest.mark.parametrize("name", sorted(HDARKNET))
def test_hdarknet_matches_flax_float64(name):
    """`HDarknet` merging groups of 3 frames by max or by the depthwise
    `conv1d_{level}` cells: its tree is flax's, the routes within 1e-9 in
    float64."""
    windows, merge, t = HDARKNET[name]
    x = _x((2, t, S, S, 3), 5)
    jm = jhd.HDarknet(windows=windows, merge_type=merge)
    v = _jax_variables(jm, x, 5)
    merges = sorted(k for k in v["params"] if k.startswith("conv1d"))
    assert merges == ([f"conv1d_{i}" for i, w in enumerate(windows) if w > 1] if merge == "conv" else [])
    ref = _f64_apply(jm, v, x)
    tm = _load(h_darknet.HDarknet(windows, merge, dtype=torch.float64).double(), v, torch.float64).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x.astype(np.float64)))
    for i, (a, b) in enumerate(zip(got, ref)):
        _close64(a.numpy(), b, f"{name} route {i}")


@pytest.mark.parametrize("conv_types", [(2, 3, 3, 2, 2, 2), (2, 21, 21, 2, 2, 2), (21, 21, 21, 21, 21, 21),
                                        (3, 3, 3, 3, 3, 3), (2, 2, 2, 2, 2, 2)],
                         ids=lambda ct: "-".join(map(str, ct)))
def test_inflate_matches_jax(conv_types):
    """`inflate_darknet53_to_3d` on the same Darknet-53 variables gives
    JAX's tree leaf for leaf, bit for bit: 3-D kernels repeated / their
    extent, 2+1D spatial kernels copied and temporal kernels 1/3, BN
    across; the 2D helpers equal JAX's."""
    conv_types = tuple(int(c) for c in conv_types)
    v2 = _jax_variables(JaxDarknet53(), np.zeros((1, S, S, 3), np.float32), 6)
    j3 = jdk.Darknet3D(conv_types=conv_types)
    shapes3 = jax.eval_shape(partial(j3.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 5, S, S, 3)))
    ref = jinflate.inflate_darknet53_to_3d(v2, fill_random(shapes3, 7), conv_types)
    template = checkpoint.variables_of(darknet3d.Darknet3D(conv_types))
    got = inflate.inflate_darknet53_to_3d(jax.tree_util.tree_map(np.asarray, v2), template)
    want = {p: np.asarray(a) for p, a in walk(ref)}
    have = dict(walk(got))
    assert have.keys() == want.keys()
    for p in want:
        assert have[p].dtype == np.float32 and np.array_equal(have[p], want[p]), p
    k2 = np.random.RandomState(8).randn(3, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(darknet3d.inflate_conv2d_to_3d(k2, 3), np.asarray(jdk.inflate_conv2d_to_3d(k2, 3)))
    for a, b in zip(darknet3d.inflate_conv2d_to_21d(k2, 3), jdk.inflate_conv2d_to_21d(k2, 3)):
        np.testing.assert_array_equal(a, np.asarray(b))


# --- the factory-built detector -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _factory_variables(name):
    kw, t = FACTORY[name]
    jm = jax_build_model(JaxYoloConfig(num_classes=NC, new_model=True, **kw))
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, t, S, S, 3)))
    return jm, shapes


def _prediction_maps(tm):
    """Forward hooks keeping each level's prediction conv output (the raw
    head before the float32 decode) as NHWC, deep first."""
    maps = {}
    for i in range(3):
        getattr(tm, f"output{i}").prediction.register_forward_hook(
            lambda mod, inp, out, i=i: maps.__setitem__(i, out.permute(0, 2, 3, 1)))
    return maps


def _jax_prediction_maps(jm, variables, x, train):
    """JAX's prediction conv outputs (NHWC, deep first), the model's
    outputs and, in train mode, its new statistics."""
    out, state = jm.apply(variables, x, train=train, mutable=["intermediates", "batch_stats"],
                          capture_intermediates=lambda mdl, _: mdl.name == "prediction")
    inter = state["intermediates"]
    return [inter[f"output{i}"]["prediction"]["__call__"][0] for i in range(3)], out, state.get("batch_stats")


@pytest.mark.parametrize("name", sorted(FACTORY))
def test_factory_detector_matches_jax(name):
    """The factory's `new_model` YOLOv3T (full widths, 3 classes) over each
    backbone: its parameter tree is JAX's; in float64 the raw heads (each
    level's prediction map, before the decode, which both packages run in
    float32) within 1e-9; in float32 its detections within 1e-4 of JAX's
    postprocess; and the port's top-k and plain NMS on JAX's own decoded
    outputs give JAX's detections exactly."""
    kw, t = FACTORY[name]
    jm, shapes = _factory_variables(name)
    v = fill_random(shapes, 9)
    cfg = YoloConfig(num_classes=NC, new_model=True, **kw)
    x = _x((2, t, S, S, 3), 9)
    tm = build_model(cfg)
    assert isinstance(tm, YOLOv3T) and tm.has_backbone and tm.k == (1 if "hierarchical" in kw else kw["k"])
    assert set(tm.state_dict()) == set(flax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros((1,) * len(s.shape)), shapes)))
    _load(tm, v).eval()
    with torch.no_grad():
        boxes, scores = tm(torch.from_numpy(x))
    rboxes, rscores = jax.jit(partial(jm.apply, train=False))(v, jnp.asarray(x))
    ref_dets = jax.device_get(jax_postprocess_tout(rboxes, rscores))
    assert_dets_close(postprocess_tout(boxes, scores), ref_dets)
    exact = postprocess_tout(torch.from_numpy(np.asarray(rboxes)), torch.from_numpy(np.asarray(rscores)))
    for a, b in zip(exact, ref_dets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((exact[0] >= 0).sum()) > 0
    del tm
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        ref = jax.jit(lambda v, x: _jax_prediction_maps(jm, v, x, False)[0])(v64, jnp.asarray(x, jnp.float64))
        ref = [np.asarray(r) for r in ref]
    t64 = _load(build_model(YoloConfig(num_classes=NC, new_model=True, dtype=torch.float64, **kw)).double(), v,
                torch.float64).eval()
    maps = _prediction_maps(t64)
    with torch.no_grad():
        t64(torch.from_numpy(x.astype(np.float64)))
    for i, r in enumerate(ref):
        assert maps[i].dtype == torch.float64
        _close64(maps[i].numpy(), r, f"{name} prediction map {i}")


def test_yolo3_3ddarknet_wrapper():
    """`yolo3_3ddarknet` builds the new_model YOLOv3T from a class list."""
    with torch.device("meta"):
        m = yolo3_3ddarknet(["a", "b"], conv_types=(2, 3, 3, 2, 2, 2), k=5)
    assert m.has_backbone and m.backbone.conv_types == (2, 3, 3, 2, 2, 2) and m.output0.num_classes == 2
    assert m.backbone.down0.ConvBNLeaky3D_0.Conv_0.weight.shape == (64, 32, 3, 3, 3)


# --- train mode and one train step in float64 -------------------------------------------

LR = dict(mode="step", base_lr=1e-2, steps_per_epoch=10, epochs=3)
TRAIN = {  # name: (the backbone from either package's module, the window, the backbone's file)
    "darknet3d-2-21-21": (lambda mod, **k: mod.Darknet3D(conv_types=(2, 21, 21, 2, 2, 2), **k), 3, "darknet3d"),
    "hdarknet-3-3-conv": (lambda mod, **k: mod.HDarknet(windows=(3, 3, 1, 1, 1), merge_type="conv", **k), 9,
                          "h_darknet"),
}
# the gradients that reach each backbone's time mixing
MIXING = {"darknet3d-2-21-21": "backbone.stage0_block0._Unit_1.Conv21DRepPad_0.temporal.weight",
          "hdarknet-3-3-conv": "backbone.conv1d_1.Conv_0.weight"}


def _train_models(name):
    """(JAX's YOLOv3T over the backbone (narrow FPN), its random variables,
    the port's float64 model on them, the window)."""
    make, t, module = TRAIN[name]
    k = t if module == "darknet3d" else 1
    jm = JaxYOLOv3T(num_classes=NC, k=k, channels=CH, backbone=make({"darknet3d": jdk, "h_darknet": jhd}[module]))
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, t, S, S, 3)))
    variables = fill_random(shapes, 10)
    backbone = make({"darknet3d": darknet3d, "h_darknet": h_darknet}[module], dtype=torch.float64)
    tm = YOLOv3T(num_classes=NC, k=k, channels=CH, backbone=backbone, dtype=torch.float64).double()
    return jm, variables, _load(tm, variables, torch.float64), t


def _check_grads(tm, grads, rtol, name):
    params = dict(tm.named_parameters())
    assert set(params) == {k for k in grads if not k.endswith("num_batches_tracked")}
    for k, g in grads.items():
        if k in params:
            err = float((params[k].grad - g).abs().max())
            assert err <= rtol * max(float(g.abs().max()), 1e-30), (k, err)
    assert float(params[MIXING[name]].grad.abs().max()) > 0


def _check_stats(tm, stats):
    ours = tm.state_dict()
    for k, r in stats.items():
        if not k.endswith("num_batches_tracked"):
            _close64(ours[k].numpy(), r.numpy(), f"statistic {k}")


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_mode_gradients_float64_match_jax(name):
    """Train mode in float64 on B=2 windows: the prediction maps (before the
    float32 decode), the gradient of every parameter of a fixed random
    projection of them, and the new running statistics within 1e-9 of
    `jax.value_and_grad` through flax: train-mode BN through the 3-D cells,
    the depthwise temporal conv, the temporal max and the merge cells."""
    jm, variables, tm, t = _train_models(name)
    x = np.random.RandomState(11).randn(2, t, S, S, 3)
    maps = _prediction_maps(tm.train())
    tm(torch.from_numpy(x))
    proj = [np.random.RandomState(12 + i).randn(*maps[i].shape) for i in range(3)]
    objective = sum((maps[i] * torch.from_numpy(proj[i])).sum() for i in range(3))
    objective.backward()

    def f(params, stats, x):
        preds, _, new_stats = _jax_prediction_maps(jm, {"params": params, "batch_stats": stats}, x, True)
        return sum(jnp.sum(p * r) for p, r in zip(preds, proj)), new_stats

    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        (value, stats), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"], v["batch_stats"],
                                                                                jnp.asarray(x))
        value = float(value)
        grads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
        stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
    np.testing.assert_allclose(float(objective.detach()), value, rtol=F64)
    _check_grads(tm, grads, F64, name)
    _check_stats(tm, stats)


class _GradState(jstep.TrainState):
    """JAX's train state whose update keeps the gradients as the params."""

    def apply_gradients(self, grads):
        return self.replace(params=grads)


def _train_batch(t, seed):
    rs = np.random.RandomState(seed)
    gtb = np.full((2, 6, 4), -1, np.float64)
    gti = np.full((2, 6, 1), -1, np.float64)
    gtb[0, :2] = [[5, 6, 40, 50], [20, 2, 60, 30]]
    gtb[1, :1] = [[10, 12, 50, 44]]
    gti[0, :2, 0] = [1, 2]
    gti[1, :1, 0] = [0]
    return {"image": rs.randn(2, t, S, S, 3), "gt_boxes": gtb, "gt_ids": gti}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_step_float64_matches_jax(name):
    """One float64 train step of YOLOv3T over each backbone (narrow FPN, B=2
    windows of normalised pixels, the targets and the loss) against JAX's
    jitted step: every running statistic within 1e-9; the losses within
    rtol 1e-6 and every parameter's gradient within 1e-5 of its largest
    magnitude (both packages decode the heads and take the loss in
    float32, tests/test_torch_rnn.py's float64 step tolerances)."""
    jm, variables, tm, t = _train_models(name)
    batch = _train_batch(t, 10)
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
    metrics = step.make_train_step(tm, num_classes=NC)(
        step.create_train_state(tm, lr.lr_schedule(**LR)), {k: torch.from_numpy(a) for k, a in batch.items()})
    for k, m in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), m, rtol=1e-6, err_msg=k)
    _check_grads(tm, grads, 1e-5, name)
    _check_stats(tm, stats)


def test_conv_merge_from_init_overflows_as_in_jax():
    """The JAX package's fault, mirrored (ROADMAP.md Queue 3): from flax's
    init the conv merges' kernels are zero, so every feature after the
    first merge is zero, each train-mode BN after it sees zero variance and
    multiplies the backward by 1/sqrt(eps), and the first step's gradient
    overflows in float32.  Both packages give the same losses and
    non-finite gradients before the merge from the same init; a max merge
    stays finite."""
    jm = JaxYOLOv3T(num_classes=NC, k=1, channels=CH, backbone=jhd.HDarknet(windows=(3, 3, 1, 1, 1), merge_type="conv"))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 9, S, S, 3)), train=False)
    assert not np.asarray(variables["params"]["backbone"]["conv1d_0"]["Conv_0"]["kernel"]).any()
    batch = {k: a.astype(np.float32) for k, a in _train_batch(9, 13).items()}
    tx = jstep.make_optimizer(jlr.lr_schedule(**LR))
    state = _GradState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]), tx=tx)
    state, jmetrics = jax.jit(jstep.make_train_step(jm, num_classes=NC))(state, batch)
    grads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, state.params)})
    bad = {k for k, g in grads.items() if not torch.isfinite(g).all()}
    assert "backbone.conv0.Conv_0.weight" in bad
    tm = _load(YOLOv3T(num_classes=NC, k=1, channels=CH, backbone=h_darknet.HDarknet((3, 3, 1, 1, 1), "conv")),
               jax.tree_util.tree_map(np.asarray, variables))
    metrics = step.make_train_step(tm, num_classes=NC)(
        step.create_train_state(tm, lr.lr_schedule(**LR)), {k: torch.from_numpy(a) for k, a in batch.items()})
    for k, m in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(m), rtol=1e-5, err_msg=k)
    ours = {k for k, p in tm.named_parameters() if not torch.isfinite(p.grad).all()}
    # where the overflow first reaches inf follows each package's summation
    # order; the layers before the first merge overflow in both
    before = {k for k in grads if k.startswith("backbone.conv0.")}
    assert before <= bad and before <= ours
    tm = YOLOv3T(num_classes=NC, k=1, channels=CH, backbone=h_darknet.HDarknet((3, 3, 1, 1, 1), "max"))
    init_weights(tm, torch.Generator().manual_seed(0))
    step.make_train_step(tm, num_classes=NC)(step.create_train_state(tm, lr.lr_schedule(**LR)),
                                             {k: torch.from_numpy(a) for k, a in batch.items()})
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters())


# --- the bridge and the checkpoints ----------------------------------------------------------

@pytest.mark.parametrize("name", ["darknet3d-2-21-21-funnel", "hdarknet-3-conv"])
def test_bridge_and_msgpack_round_trip(name, tmp_path):
    """JAX's variables -> the bridge -> the port (strict) -> back: the same
    tree, leaf for leaf; a JAX-written `.params` read by the port and the
    port's read by JAX, equal.  A strict load fails on a leaf the bridge did
    not place and on one it left out."""
    kw, _ = FACTORY[name]
    _, shapes = _factory_variables(name)
    v = jax.tree_util.tree_map(np.asarray, fill_random(shapes, 11))
    tm = _load(build_model(YoloConfig(num_classes=NC, new_model=True, **kw)), v)
    back = checkpoint.variables_of(tm)
    want = dict(walk(v))
    assert dict(walk(back)).keys() == want.keys()
    assert all(np.array_equal(a, want[p]) for p, a in walk(back))
    state = flax_to_state_dict(v)
    extra = dict(state, **{"backbone.stray.weight": torch.zeros(1)})
    missing = {k: t for k, t in state.items() if "temporal" not in k and "conv1d" not in k}
    assert len(missing) < len(state)
    for bad in (extra, missing):
        with pytest.raises(RuntimeError):
            tm.load_state_dict(bad, strict=True)
    path = str(tmp_path / "jax.params")
    try:
        jckpt.save_variables(path, v)
        ours = checkpoint.load_variables(path, checkpoint.variables_of(tm))
        checkpoint.load_into(tm, ours)
        checkpoint.save_variables(path, checkpoint.variables_of(tm))
        again = jckpt.load_variables(path, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
        assert all(np.array_equal(np.asarray(a), want[p]) for p, a in walk(dict(again)))
    finally:
        os.remove(path)


# --- the refusals beside JAX's behaviour -----------------------------------------------------

def test_3d_cells_on_images_mix_the_batch_in_jax_and_raise_here():
    """A 3-D stage handed images (the factory's k = 1 with `--conv_types
    2,3,...` and a window of 1): flax's 3-D conv reads the batch as time, so
    JAX's routes of an image move with the other image of its batch; the
    port raises ValueError, from the backbone and from the factory's model."""
    x = _x((2, S, S, 3), 12)
    jm = jdk.Darknet3D(conv_types=(2, 3, 3, 2, 2, 2))
    v = fill_random(jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.asarray(x)), 12)
    first_route = jax.jit(lambda v, x: jm.apply(v, x, train=False)[0])
    pair, same = first_route(v, jnp.asarray(x)), first_route(v, jnp.asarray(np.concatenate([x[:1], x[:1]])))
    assert float(jnp.abs(pair[0] - same[0]).max()) > 1e-3
    with pytest.raises(ValueError, match="mixes its images"):
        darknet3d.Darknet3D((2, 3, 3, 2, 2, 2))(torch.from_numpy(x))
    model = build_model(YoloConfig(num_classes=NC, new_model=True, conv_types=(2, 21, 21, 2, 2, 2))).eval()
    assert model.k == 1
    with pytest.raises(ValueError, match="mixes its images"), torch.no_grad():
        model(torch.from_numpy(x))


def test_darknet3d_conv_type_refusals_beside_jax():
    """A stride-8 route tapped before the temporal pool keeps its time axis:
    JAX returns it 5-D and its YOLOv3T fails in the FPN; a return to 3-D
    after the pool fails JAX's assert; the port raises ValueError for both,
    and for a conv type outside 2, 3, 21."""
    x = np.zeros((1, 5, S, S, 3), np.float32)
    late = (2, 2, 2, 3, 2, 2)
    routes = jax.eval_shape(partial(jdk.Darknet3D(conv_types=late).init_with_output, train=False),
                            jax.random.PRNGKey(0), x)[0]
    assert [len(r.shape) for r in routes] == [5, 4, 4]
    with pytest.raises(Exception):
        jax.eval_shape(partial(JaxYOLOv3T(num_classes=NC, k=5, backbone=jdk.Darknet3D(conv_types=late)).init,
                               train=False), jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="keeps its time axis"):
        darknet3d.Darknet3D(late)
    back = (3, 2, 3, 2, 2, 2)
    with pytest.raises(AssertionError):
        jax.eval_shape(partial(jdk.Darknet3D(conv_types=back).init, train=False), jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="return to 3D"):
        darknet3d.Darknet3D(back)
    with pytest.raises(ValueError, match="conv_types"):
        darknet3d.Darknet3D((2, 4, 2, 2, 2, 2))


def test_hdarknet_refusals_beside_jax():
    """Windows that do not collapse t to 1, t not a multiple of 3 and a fifth
    window fail JAX's asserts and raise ValueError here; a conv merge that
    an input skips (t=3 under windows 3, 3) builds in JAX without its
    `conv1d_1`, and the port, which holds that cell, raises ValueError."""
    def jax_init(windows, merge, t):
        jm = jhd.HDarknet(windows=windows, merge_type=merge)
        return jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, t, S, S, 3)))

    for windows, t, match in (((3, 1, 1, 1, 1), 9, "collapse"), ((3, 1, 1, 1, 1), 4, "windows of 3")):
        with pytest.raises(AssertionError):
            jax_init(windows, "max", t)
        with pytest.raises(ValueError, match=match):
            h_darknet.HDarknet(windows)(torch.zeros(1, t, S, S, 3))
    with pytest.raises(AssertionError):
        jax_init((3, 1, 1, 1, 3), "max", 3)
    with pytest.raises(ValueError, match="fifth"):
        h_darknet.HDarknet((3, 1, 1, 1, 3))
    with pytest.raises(ValueError, match="merge_type"):
        h_darknet.HDarknet((3, 1, 1, 1, 1), "mean")
    assert sorted(k for k in jax_init((3, 3, 1, 1, 1), "conv", 3)["params"] if k.startswith("conv1d")) == ["conv1d_0"]
    with pytest.raises(ValueError, match="conv1d_1"):
        h_darknet.HDarknet((3, 3, 1, 1, 1), "conv")(torch.zeros(1, 3, S, S, 3))
    with torch.no_grad():  # a max merge holds no cell: JAX's behaviour
        routes = h_darknet.HDarknet((3, 3, 1, 1, 1), "max").eval()(torch.zeros(1, 3, S, S, 3))
    assert routes[0].shape == (1, S // 8, S // 8, 256)


def test_yolov3t_backbone_refusals_beside_jax():
    """The R(2+1)D two-stream config and any backbone other than Darknet3D,
    HDarknet or the FlowNet two-stream still raise item 7; int8 with a
    backbone item 9a; the conv-RNN and 3-D blocks on a backbone's 4-D
    routes ValueError; the stream refuses a custom backbone, as JAX's
    asserts."""
    with pytest.raises(NotImplementedError, match="item 7"):
        YOLOv3T(num_classes=NC, k=3, backbone=torch.nn.Identity())
    with pytest.raises(NotImplementedError, match="item 7"):
        build_model(YoloConfig(num_classes=NC, k=9, motion_stream="r21d", new_model=True))
    with torch.device("meta"):
        bb = darknet3d.Darknet3D((2, 3, 3, 2, 2, 2))
        with pytest.raises(NotImplementedError, match="item 9a"):
            YOLOv3T(num_classes=NC, k=5, backbone=bb, quant="fused")
        for kw in (dict(rnn_pos="out"), dict(k_join_pos="late", k_join_type="max", block_conv_type="3")):
            with pytest.raises(ValueError, match="4-D"):
                YOLOv3T(num_classes=NC, k=5, backbone=bb, **kw)
    model = build_model(YoloConfig(num_classes=NC, new_model=True, k=3, conv_types=(2, 3, 3, 2, 2, 2)))
    with pytest.raises(ValueError, match="built-in per-frame backbone"):
        StreamingDetector(model)
    jm, shapes = _factory_variables("hdarknet-3-conv")
    with pytest.raises(AssertionError):
        jstreaming.make_streaming_step(jm, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
