"""The two-stream FlowNet family (ROADMAP.md Queue 1 item 7, its FlowNet
half) against the JAX package on the CPU: `FlowNetS` and `FlowNetC` (the
concat3/4/5 features, the eval flow, the train pyramid), the decoder's
transposed convs and the bridge's flip of their kernels, FlowNetC's cost
volume at d=20, stride2=2 (the XLA form and the Pallas kernel in
interpret mode; K2's plan at FlowNetC's level, and K2's CUDA source built
for the CPU and run under that plan's instance), `TwoStreamDarknet`'s routes
ungated and gated by "mul", the factory's two-stream YOLOv3T gated by
"add" (the prediction maps, the detections, the top-k and plain NMS),
train-mode gradients and one float64 train step, the bridge and flax
msgpack both ways, `flownet_utils` (crop, normalise, the colour wheel,
`.flo` bytes, `process_two_images`, `process_imagedir`, the FlowNet2-S
`.pth` importer), and the refusals beside the JAX package's behaviour.

Inputs are numpy arrays from a seed, the flax variables random
(tests/test_torch_rnn.py's `fill_random`) and carried across by the bridge;
64 px (a multiple of 64, as FlowNetS needs).  Tolerances: in float64 the
flows, features, routes, prediction maps and, in train mode, every gradient
of a projection of the prediction maps within 1e-9 of each tensor's
largest magnitude (FlowNetC's cost volume in float64 on both sides:
`layers.CORR_DTYPE` and the JAX module's `jnp` monkeypatched); detections
within tests/test_torch_streaming.py's 1e-4; the top-k and NMS on the same
candidates exact; the float64 train step's losses within rtol 1e-6 and its
gradients within 1e-5 (both packages decode and take the loss in
float32); the cost volume in float32 within 1e-5; the numpy helpers and
the importer bit for bit; `process_two_images` in float32 within 1e-4 of
the flow's magnitude."""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import chip_smoke
from test_torch_backbones import (
    LR, _GradState, _check_stats, _close64, _jax_prediction_maps, _prediction_maps, _train_batch,
)
from test_torch_corr_grad_plan import cpu_library  # noqa: F401  (the fixture: K2's source built for the CPU)
from test_torch_ops import _assert_corr_plan
from test_torch_rnn import NC, S, fill_random
from test_torch_streaming import assert_dets_close
from test_torch_train_temporal import _Float64Jnp
from videoyolo_tpu import streaming as jstreaming
from videoyolo_tpu.models import flownet as jflownet
from videoyolo_tpu.models import flownet_utils as jutils
from videoyolo_tpu.models import ts_darknet as jts
from videoyolo_tpu.models.factory import YoloConfig as JaxYoloConfig
from videoyolo_tpu.models.factory import build_model as jax_build_model
from videoyolo_tpu.models.yolo3 import postprocess_tout as jax_postprocess_tout
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.ops.correlation import correlation as jax_correlation
from videoyolo_tpu.ops.pallas_correlation import correlation_pallas
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.train import lr as jlr
from videoyolo_tpu.train import step as jstep
from videoyolo_torch.models import flownet, flownet_utils, layers, ts_darknet
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.layers import ConvTranspose2d
from videoyolo_torch.models.yolo3 import postprocess_tout
from videoyolo_torch.models.yolo3_temporal import YOLOv3T
from videoyolo_torch.ops import correlation_kernel
from videoyolo_torch.ops.correlation import correlation
from videoyolo_torch.streaming import StreamingDetector
from videoyolo_torch.train import checkpoint, lr, step
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax, walk
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)
from torch_heap import trim_heap

torch.set_num_threads(2)

CH = (16, 8, 4)  # narrow FPN channels for the train-mode models
NETS = {"flownets": (jflownet.FlowNetS, flownet.FlowNetS), "flownetc": (jflownet.FlowNetC, flownet.FlowNetC)}


def _x(shape, seed, dtype=np.float32):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


def _jax_variables(jm, x, seed):
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.asarray(x))
    return fill_random(shapes, seed)


def _load(tm, variables, dtype=torch.float32):
    state = flax_to_state_dict(variables)
    tm.load_state_dict({k: t.to(dtype) if t.is_floating_point() else t for k, t in state.items()}, strict=True)
    return tm


@pytest.fixture
def float64_volumes():
    """Both packages' FlowNetC cost volumes in float64 (each casts its
    features to float32 before the correlation)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jflownet, "jnp", _Float64Jnp())
        mp.setattr(layers, "CORR_DTYPE", torch.float64)
        yield


def _jax64(fn, variables, x):
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(v, jnp.asarray(x, np.float64)))


# --- FlowNetS and FlowNetC ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NETS))
def test_flownet_matches_flax_float64(name, float64_volumes):
    """On (2, 2, 64, 64, 3) pairs in float64: the concat3/4/5 features
    (return_features), the train pyramid (flow2 ... flow6) and the eval
    flow2 within 1e-9 of flax's; the bridge carries the tree across and
    back leaf for leaf; FlowNetS also takes the pair stacked on channels.
    Loaded without the bridge's flip of the transposed convs' kernels, the
    flows differ (the flip is needed)."""
    jcls, tcls = NETS[name]
    x = _x((2, 2, S, S, 3), 1)
    v = _jax_variables(jcls(), x, 1)
    pyramid = _jax64(lambda v, x: jcls().apply(v, x, train=True), v, x)
    feats = _jax64(lambda v, x: jcls(return_features=True).apply(v, x), v, x)
    tm = _load(tcls(dtype=torch.float64).double(), v, torch.float64)
    x64 = torch.from_numpy(x.astype(np.float64))
    with torch.no_grad():
        got_pyramid = tm.train()(x64)
        got_flow = tm.eval()(x64)
        tm.return_features = True
        got_feats = tm(x64)
        tm.return_features = False
        if name == "flownets":
            _close64(tm(flownet.stack_frames_on_channels(x64)).numpy(), pyramid[0], "stacked pair's flow")
    assert [tuple(f.shape) for f in got_pyramid] == [(2, S // s, S // s, 2) for s in (4, 8, 16, 32, 64)]
    assert [f.shape[-1] for f in got_feats] == list(flownet.CONCAT_CHANNELS) == [386, 770, 1026]
    for i, (a, b) in enumerate(zip(got_pyramid, pyramid)):
        _close64(a.numpy(), b, f"{name} flow{i + 2}")
    _close64(got_flow.numpy(), pyramid[0], f"{name} eval flow")
    for i, (a, b) in enumerate(zip(got_feats, feats)):
        _close64(a.numpy(), b, f"{name} concat{i + 3}")
    back = state_dict_to_flax(tm.state_dict())
    want = dict(walk(v))
    assert dict(walk(back)).keys() == want.keys()
    assert all(np.array_equal(a, want[p].astype(np.float64).astype(np.float32)) for p, a in walk(back))
    # the transposed convs loaded without the flip: the flows move
    unflipped = {k: (t.flip(2, 3) if ("deconv" in k or "upsampled_flow" in k) and t.dim() == 4 else t)
                 for k, t in tm.state_dict().items()}
    tm.load_state_dict(unflipped)
    with torch.no_grad():
        err = float((tm.eval()(x64) - torch.from_numpy(pyramid[0])).abs().max())
    assert err > 1e-3 * float(np.abs(pyramid[0]).max()), err


@pytest.mark.parametrize("bias", [True, False])
def test_transposed_conv_matches_flax(bias):
    """`layers.ConvTranspose2d` (torch's (in, out, kh, kw) weight, applied
    flipped) on the bridged kernel equals flax's `ConvTranspose((4, 4),
    strides=2, padding="SAME")`, whose kernel is applied as it is: 2H x
    2W out, float64 within 1e-12; the unflipped kernel does not."""
    x = _x((2, 5, 7, 6), 2, np.float64)
    jm = fnn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME", use_bias=bias)
    with jax.enable_x64(True):
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * np.random.RandomState(3).randn(*a.shape), v)
        ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    state = flax_to_state_dict({"params": {"deconv2": v["params"]}})
    tm = ConvTranspose2d(6, 3, bias=bias, dtype=torch.float64).double()
    tm.load_state_dict({k.split(".", 1)[1]: t for k, t in state.items()})
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == ref.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"])).permute(2, 3, 0, 1))
    assert np.abs(tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy() - ref).max() > 1e-3


# --- FlowNetC's cost volume: d=20, stride2=2 ---------------------------------------

def test_correlation_d20_stride2_matches_jax():
    """`correlation(..., 20, 1, 1, 2)` (the plain version, on the CPU)
    against JAX's XLA form and its Pallas kernel in interpret mode: 441
    channels within 1e-5 in float32, the XLA form within 1e-12 in float64."""
    f1, f2 = (np.random.RandomState(s).randn(2, 12, 10, 16).astype(np.float32) for s in (4, 5))
    got = correlation(torch.from_numpy(f1), torch.from_numpy(f2), 20, 1, 1, 2).numpy()
    assert got.shape == (2, 12, 10, 441)
    np.testing.assert_allclose(got, np.asarray(jax_correlation(jnp.asarray(f1), jnp.asarray(f2), 20, 1, 1, 2)),
                               rtol=1e-5, atol=1e-5)
    pallas = correlation_pallas(jnp.asarray(f1), jnp.asarray(f2), 20, stride2=2, row_tile=4, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    with jax.enable_x64(True):
        ref = np.asarray(jax_correlation(jnp.asarray(f1, np.float64), jnp.asarray(f2, np.float64), 20, 1, 1, 2))
    got64 = correlation(torch.from_numpy(f1).double(), torch.from_numpy(f2).double(), 20, 1, 1, 2).numpy()
    np.testing.assert_allclose(got64, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("b", [16, 1])
def test_k2_plan_at_flownetc_level(b):
    """K2's plan at FlowNetC's level of a 384-px pair, (B, 48, 48, 256)
    float32, d=20, stride2=2 (441 displacements, 21 a row): R=1 (stride2 >
    1), 7 displacement columns a group, one row (gx does not cover a row),
    two warps on 8x8 tiles, 16-byte copies; 36 tiles x 63 groups a pair."""
    pl = _assert_corr_plan(b, 48, 48, 256, 20, 2)
    assert (pl.r, pl.gx, pl.gy, pl.nacc, pl.tile, pl.threads, pl.copy) == (1, 7, 1, 7, (8, 8), 64, 16)
    assert pl.grid == (36, 63, b) and pl.live == 1.0 and pl.smem <= correlation_kernel.SMEM_BYTES
    assert pl.ctas == 36 * 63 * b


def test_k2_source_under_flownetc_plan_on_the_cpu(cpu_library):  # noqa: F811
    """csrc/correlation.cu built for the CPU (tests/test_torch_corr_grad_plan.py)
    runs FlowNetC's instance (R=1, gx=7, gy=1, two warps) at d=20, stride2=2
    on a small map with ragged tiles: within 1e-5 of the plain version."""
    gen = torch.Generator().manual_seed(7)
    fa, fb = (torch.randn(2, 13, 11, 32, generator=gen) for _ in range(2))
    k = correlation_kernel
    pl = k._make(2, 13, 11, 32, 21, 2, 1, 7, 1, 2, k.aligned(fa, fb))
    assert (pl.r, pl.gx, pl.gy, pl.threads) == (1, 7, 1, 64)
    out = torch.full((2, 13, 11, 441), float("nan"))
    assert cpu_library.cost_volume_launch(fa.data_ptr(), fb.data_ptr(), out.data_ptr(), fa.stride(0), fb.stride(0),
                                          2, 13, 11, 32, 20, 2, pl.r, pl.gx, pl.gy, pl.threads, pl.copy, pl.smem,
                                          pl.grid[0], pl.grid[1], None) == 0
    torch.testing.assert_close(out, correlation(fa, fb, 20, 1, 1, 2), rtol=1e-5, atol=1e-5)


# --- the two-stream backbone ---------------------------------------------------------

@pytest.mark.parametrize("add_type", [None, "mul"], ids=["ungated", "mul"])
def test_two_stream_backbone_matches_flax_float64(add_type):
    """`TwoStreamDarknet` on (2, 3, 64, 64, 3) windows: its tree is flax's
    (`flow_encoder`, `flow_decoder`, and `conv0`, `stage1-5` or `gstart`,
    `gstage4`, `stage5`), the three routes (256 + 386, 512 + 770, 1024 + 1026
    channels) within 1e-9 in float64."""
    x = _x((2, 3, S, S, 3), 5)
    jm = jts.TwoStreamDarknet(add_type=add_type)
    v = _jax_variables(jm, x, 5)
    tops = sorted(v["params"])
    assert tops == (["conv0", "flow_decoder", "flow_encoder"] + [f"stage{i}" for i in range(1, 6)] if add_type is None
                    else ["flow_decoder", "flow_encoder", "gstage4", "gstart", "stage5"])
    ref = _jax64(lambda v, x: jm.apply(v, x, train=False), v, x)
    tm = _load(ts_darknet.TwoStreamDarknet(add_type=add_type, dtype=torch.float64).double(), v, torch.float64).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x.astype(np.float64)))
    assert [tuple(r.shape) for r in got] == [(2, S // 8, S // 8, 642), (2, S // 16, S // 16, 1282),
                                            (2, S // 32, S // 32, 2050)]
    assert tuple(tm.route_channels) == (642, 1282, 2050)
    for i, (a, b) in enumerate(zip(got, ref)):
        _close64(a.numpy(), b, f"{add_type} route {i}")


# --- the factory's two-stream detector -------------------------------------------------

FACTORY = dict(k=3, motion_stream="flownet", add_type="add")


def test_factory_two_stream_detector_matches_jax():
    """`build_model(motion_stream="flownet", k=3, add_type="add")` (full
    widths, 3 classes) is YOLOv3T over `TwoStreamDarknet`: its parameter
    tree is JAX's; in float32 its detections within 1e-4 of JAX's
    postprocess and the port's top-k and plain NMS on JAX's decoded outputs
    exactly JAX's; in float64 the prediction maps (before the float32
    decode) within 1e-9."""
    jm = jax_build_model(JaxYoloConfig(num_classes=NC, **FACTORY))
    x = _x((2, 3, S, S, 3), 9)
    v = _jax_variables(jm, x, 9)
    tm = build_model(YoloConfig(num_classes=NC, **FACTORY))
    assert isinstance(tm, YOLOv3T) and isinstance(tm.backbone, ts_darknet.TwoStreamDarknet) and tm.k == 3
    assert tm.backbone.add_type == "add" and not (tm.early_join or tm.early_corr or tm.late_join or tm.late_corr)
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
    ref = _jax64(lambda v, x: _jax_prediction_maps(jm, v, x, False)[0], v, x)
    jax.clear_caches()
    t64 = _load(build_model(YoloConfig(num_classes=NC, dtype=torch.float64, **FACTORY)).double(), v,
                torch.float64).eval()
    maps = _prediction_maps(t64)
    with torch.no_grad():
        t64(torch.from_numpy(x.astype(np.float64)))
    for i, r in enumerate(ref):
        _close64(maps[i].numpy(), r, f"prediction map {i}")


# --- train mode: the gradients and one float64 step ------------------------------------------

@pytest.fixture(scope="module")
def train_models():
    """(JAX's YOLOv3T over the "add" two-stream backbone with the narrow
    FPN, its random variables, the port's float64 model on them)."""
    jm = JaxYOLOv3T(num_classes=NC, k=3, channels=CH, backbone=jts.TwoStreamDarknet(add_type="add"))
    v = _jax_variables(jm, np.zeros((1, 3, S, S, 3), np.float32), 10)
    tm = YOLOv3T(num_classes=NC, k=3, channels=CH, dtype=torch.float64,
                 backbone=ts_darknet.TwoStreamDarknet(add_type="add", dtype=torch.float64)).double()
    return jm, v, _load(tm, v, torch.float64)


def test_train_mode_gradients_float64_match_jax(train_models):
    """Train mode in float64 on B=2 windows: the prediction maps, the
    gradient of every parameter of a fixed random projection of them
    (through the gates, FlowNetS and its transposed convs) and the new
    running statistics within 1e-9 of `jax.value_and_grad` through flax."""
    jm, variables, tm = train_models
    x = np.random.RandomState(11).randn(2, 3, S, S, 3)
    maps = _prediction_maps(tm.train())
    tm.zero_grad()
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
    jax.clear_caches()
    np.testing.assert_allclose(float(objective.detach()), value, rtol=1e-9)
    params = dict(tm.named_parameters())
    assert set(params) == {k for k in grads if not k.endswith("num_batches_tracked")}
    unreached = {k for k, p in params.items() if p.grad is None}
    # the decoder's two finest flows (predict_flow3 and predict_flow2,
    # deconv2, upsampled_flow3_to_2) are not in the routes: no gradient
    # here, zeros in JAX
    assert unreached == {f"backbone.flow_decoder.{m}.{leaf}" for m, leaves in (
        ("predict_flow3", ("weight", "bias")), ("predict_flow2", ("weight", "bias")),
        ("deconv2", ("weight", "bias")), ("upsampled_flow3_to_2", ("weight",))) for leaf in leaves}
    for k, g in grads.items():
        if k in unreached:
            assert not g.any(), k
        elif k in params:
            _close64(params[k].grad.numpy(), g.numpy(), f"gradient {k}")
    for key in ("backbone.flow_decoder.deconv3.weight", "backbone.flow_encoder.conv1.weight",
                "backbone.gstart.g1_reduce.Conv_0.weight"):
        assert float(params[key].grad.abs().max()) > 0, key
    _check_stats(tm, stats)
    # the running statistics back to the variables' for the train step
    _load(tm, variables, torch.float64)


def test_train_step_float64_matches_jax(train_models):
    """One float64 train step (B=2 windows of normalised pixels, the targets
    and the loss) against JAX's jitted step: every running statistic within
    1e-9; the losses within rtol 1e-6 and every parameter's gradient within
    1e-5 of its largest magnitude (tests/test_torch_backbones.py's float64
    step tolerances)."""
    jm, variables, tm = train_models
    batch = _train_batch(3, 10)
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
    tm = _load(tm, variables, torch.float64)
    tm.zero_grad(set_to_none=True)
    metrics = step.make_train_step(tm, num_classes=NC)(
        step.create_train_state(tm, lr.lr_schedule(**LR)), {k: torch.from_numpy(a) for k, a in batch.items()})
    for k, m in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), m, rtol=1e-6, err_msg=k)
    params = dict(tm.named_parameters())
    for k, g in grads.items():
        if k in params:
            err = float((params[k].grad - g).abs().max())
            assert err <= 1e-5 * max(float(g.abs().max()), 1e-30), (k, err)
    assert float(params["backbone.flow_encoder.conv4_1.weight"].grad.abs().max()) > 0
    # the step's zero gradient where the loss does not reach: the update
    # decays those parameters, as optax's
    assert not params["backbone.flow_decoder.predict_flow2.weight"].grad.any()
    _check_stats(tm, stats)


def test_bridge_and_msgpack_round_trip(train_models, tmp_path):
    """JAX's variables of the gated two-stream YOLOv3T -> the bridge -> the
    port (strict) -> back: the same tree leaf for leaf (the transposed
    convs' kernels flipped there and back); a JAX-written `.params` read by
    the port and the port's read by JAX, equal."""
    _, v, _ = train_models
    tm = _load(YOLOv3T(num_classes=NC, k=3, channels=CH, backbone=ts_darknet.TwoStreamDarknet(add_type="add")), v)
    want = dict(walk(v))
    back = dict(walk(checkpoint.variables_of(tm)))
    assert back.keys() == want.keys()
    assert all(np.array_equal(a, want[p]) for p, a in back.items())
    assert tm.backbone.flow_decoder.deconv5.weight.shape == (1024, 512, 4, 4)
    path = str(tmp_path / "jax.params")
    try:
        jckpt.save_variables(path, v)
        checkpoint.load_into(tm, checkpoint.load_variables(path, checkpoint.variables_of(tm)))
        checkpoint.save_variables(path, checkpoint.variables_of(tm))
        again = jckpt.load_variables(path, jax.tree_util.tree_map(np.zeros_like, v))
        assert all(np.array_equal(np.asarray(a), want[p]) for p, a in walk(dict(again)))
    finally:
        os.remove(path)


# --- flownet_utils -----------------------------------------------------------------------------

def test_numpy_helpers_bit_for_bit(tmp_path):
    """crop, normalise, the colour wheel, `compute_color` and
    `flow_to_image` (NaN, unknown and large flows among them) equal the JAX
    package's bit for bit; `.flo` files are byte for byte JAX's and each
    package reads the other's."""
    rs = np.random.RandomState(13)
    imgs = rs.randint(0, 256, (2, 100, 141, 3)).astype(np.uint8)
    np.testing.assert_array_equal(flownet_utils.crop_to_64(imgs), jutils.crop_to_64(imgs))
    assert flownet_utils.crop_to_64(imgs).shape == (2, 64, 128, 3)
    np.testing.assert_array_equal(flownet_utils.normalise_pair(imgs), jutils.normalise_pair(imgs))
    np.testing.assert_array_equal(flownet_utils.make_color_wheel(), jutils.make_color_wheel())
    flow = (rs.randn(9, 11, 2) * 3).astype(np.float32)
    flow[0, 0, 0], flow[1, 1] = np.nan, 2e7
    u, v = flow[..., 0] / 5, flow[..., 1] / 5
    np.testing.assert_array_equal(flownet_utils.compute_color(u, v), jutils.compute_color(u, v))
    img = flownet_utils.flow_to_image(flow)
    np.testing.assert_array_equal(img, jutils.flow_to_image(flow))
    assert img.dtype == np.uint8 and img.shape == (9, 11, 3) and not img[1, 1].any()
    ours, theirs = str(tmp_path / "ours.flo"), str(tmp_path / "theirs.flo")
    flownet_utils.write_flo(ours, flow)
    jutils.write_flo(theirs, flow)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(flownet_utils.read_flo(theirs), jutils.read_flo(ours))
    with open(ours, "r+b") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(ValueError, match="magic"):
        flownet_utils.read_flo(ours)


def test_process_two_images_and_imagedir_match_jax(tmp_path):
    """`process_two_images` on the CPU (FlowNetS, float32, bridged
    weights) on two 100 x 141 frames: the flow of their centre 64 x 128
    crop, within 1e-4 of the flow's magnitude of JAX's; `process_imagedir`
    over three JPEG frames (the JPEG core's pixels) writes one `.flo` a
    consecutive pair, each that pair's flow."""
    rs = np.random.RandomState(14)
    img1, img2 = (rs.randint(0, 256, (100, 141, 3)).astype(np.uint8) for _ in range(2))
    jm = jflownet.FlowNetS()
    v = _jax_variables(jm, np.zeros((1, 2, S, S, 3), np.float32), 14)
    tm = _load(flownet.FlowNetS(), v)
    got = flownet_utils.process_two_images(tm, img1, img2, device="cpu")
    ref = jutils.process_two_images(jm, v, img1, img2)
    assert got.shape == ref.shape == (16, 32, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()))
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        (frames / f"{i:06d}.jpg").write_bytes(chip_smoke.encode_jpeg(rs.randint(0, 256, (72, 130, 3)).astype(np.uint8)))
    flows = flownet_utils.process_imagedir(tm, str(frames), device="cpu")
    assert sorted(os.listdir(frames / "flow")) == ["000000.flo", "000001.flo"] and len(flows) == 2
    from videoyolo_torch.data.base import read_image

    for i, f in enumerate(flows):
        np.testing.assert_array_equal(flownet_utils.read_flo(str(frames / "flow" / f"{i:06d}.flo")), f)
        pair = [read_image(str(frames / f"{j:06d}.jpg")) for j in (i, i + 1)]
        np.testing.assert_array_equal(f, flownet_utils.process_two_images(tm, *pair, device="cpu"))


def _flownet2s_state(rs, tm):
    """A FlowNet2-S checkpoint's state dict of random tensors in NVIDIA's
    names and layouts (Sequential(conv, leaky) encoder and deconvs, bare
    flow predictions with a bias, bias-free flow upsamplers)."""
    state = {}
    for name in flownet_utils._ENC_CONVS:
        w = getattr(tm.encoder, name).weight
        state[f"{name}.0.weight"] = torch.from_numpy(rs.randn(*w.shape).astype(np.float32))
        state[f"{name}.0.bias"] = torch.from_numpy(rs.randn(w.shape[0]).astype(np.float32))
    for name in flownet_utils._DEC:
        m = getattr(tm.decoder, name)
        prefix = f"{name}.0" if name.startswith("deconv") else name
        state[f"{prefix}.weight"] = torch.from_numpy(rs.randn(*m.weight.shape).astype(np.float32))
        if m.bias is not None:
            state[f"{prefix}.bias"] = torch.from_numpy(rs.randn(*m.bias.shape).astype(np.float32))
    return state


def test_convert_torch_flownet_matches_jax(tmp_path):
    """A FlowNet2-S `.pth` written here: the port's importer into FlowNetS
    gives JAX's importer's variables through the bridge, leaf for leaf,
    bit for bit (the transposed convs' weights taken as they are against
    JAX's flipped kernels); both raise KeyError on a missing entry and
    refuse a wrong shape (JAX AssertionError, the port ValueError)."""
    jm = jflownet.FlowNetS()
    v = _jax_variables(jm, np.zeros((1, 2, S, S, 3), np.float32), 15)
    tm = _load(flownet.FlowNetS(), v)
    state = _flownet2s_state(np.random.RandomState(15), tm)
    path = str(tmp_path / "FlowNet2-S_checkpoint.pth")
    torch.save({"epoch": 3, "best_EPE": 2.5, "state_dict": state}, path)
    ref = flax_to_state_dict(jutils.convert_torch_flownet(path, v))
    assert flownet_utils.convert_torch_flownet(path, tm) is tm
    got = tm.state_dict()
    assert got.keys() == ref.keys()
    for key, want in ref.items():
        assert torch.equal(got[key], want), key
    torch.testing.assert_close(tm.decoder.deconv4.weight, state["deconv4.0.weight"], rtol=0, atol=0)
    torch.save({k: t for k, t in state.items() if k != "conv6.0.bias"}, path)
    for convert, model in ((jutils.convert_torch_flownet, v), (flownet_utils.convert_torch_flownet, tm)):
        with pytest.raises(KeyError):
            convert(path, model)
    state["predict_flow3.weight"] = torch.zeros(2, 385, 3, 3)
    torch.save(state, path)
    with pytest.raises(AssertionError):
        jutils.convert_torch_flownet(path, v)
    with pytest.raises(ValueError, match="predict_flow3"):
        flownet_utils.convert_torch_flownet(path, tm)


# --- the refusals beside JAX's behaviour -----------------------------------------------------

def test_refusals_beside_jax():
    """The R(2+1)D stream builds, as JAX's does (tests/test_torch_r21d.py
    holds it to JAX); a flownet stream with k other than 3 fails JAX's
    assert and raises ValueError here, as an unknown stream or gating does;
    the int8 model raises item 9a; 416-px windows fail JAX's encoder
    assertion and raise the same message here; the streaming detector
    refuses the two-stream backbone, as JAX's stream asserts."""
    with torch.device("meta"):
        assert build_model(YoloConfig(num_classes=NC, k=9, motion_stream="r21d")).backbone.stream == "r21d"
        assert not hasattr(ts_darknet.TwoStreamDarknet(stream="r21d", t=9), "flow_encoder")
    with pytest.raises(AssertionError, match="k=3"):
        jax_build_model(JaxYoloConfig(num_classes=NC, k=5, motion_stream="flownet"))
    with pytest.raises(ValueError, match="k=3"):
        build_model(YoloConfig(num_classes=NC, k=5, motion_stream="flownet"))
    with pytest.raises(ValueError, match="motion_stream"):
        build_model(YoloConfig(num_classes=NC, k=3, motion_stream="flow"))
    with pytest.raises(ValueError, match="add_type"):
        ts_darknet.TwoStreamDarknet(add_type="sub")
    with pytest.raises(NotImplementedError, match="item 9a"):
        ts_darknet.TwoStreamDarknet(quant="fused")
    jm = jax_build_model(JaxYoloConfig(num_classes=NC, **FACTORY))
    with pytest.raises(AssertionError, match="divisible by 64, got \\(416, 416\\)") as jax_err:
        jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 3, 416, 416, 3)))
    with torch.device("meta"):
        model = build_model(YoloConfig(num_classes=NC, **FACTORY))
    with pytest.raises(ValueError) as ours:
        model(torch.zeros(1, 3, 416, 416, 3, device="meta"))
    assert str(ours.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="built-in per-frame backbone"):
        StreamingDetector(model.eval())
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jnp.zeros((1, 3, S, S, 3)))
    with pytest.raises(AssertionError, match="built-in per-frame backbone"):
        jstreaming.make_streaming_step(jm, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
