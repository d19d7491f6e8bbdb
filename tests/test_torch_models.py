"""The port's models against the JAX package's, on the CPU, with the same
weights carried across by the flax bridge: the cells, a narrow Darknet-53,
the head, the post-processing, the slice end to end, one full-width YOLOv3
at 128 px, and bf16 once.

Weights: random flax variables made with numpy from a seed in the shapes
`jax.eval_shape(model.init)` gives (BN statistics away from identity, so the
bridge of every leaf is exercised)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoyolo_tpu.models import darknet as jdarknet
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models import yolo3 as jyolo3
from videoyolo_torch.models import darknet, layers, yolo3
from videoyolo_torch.models.factory import YoloConfig, build_model, yolo3_darknet53, yolo3_no_backbone
from videoyolo_torch.models.yolo3_temporal import YOLOv3T
from videoyolo_torch.train.step import create_train_state, make_train_step
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

NARROW = dict(layers=(1, 1, 1, 1, 1), channels=(8, 16, 16, 32, 32, 64))
HEAD = (32, 16, 8)
TOL = dict(rtol=1e-4, atol=1e-4)  # float32 on both sides, other summation orders


def random_variables(module, x, seed, gain=1.0):
    shapes = jax.eval_shape(partial(module.init, train=False), jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rs.randn(*shape).astype(np.float32) * gain / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rs.randn(*shape) * 0.1).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


def bridged(torch_module, variables):
    torch_module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return torch_module.eval()


def jax_apply(module, variables, *args):
    return jax.jit(partial(module.apply, train=False))(variables, *args)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2)])
def test_conv_bn_leaky(kernel, stride):
    x = np.random.RandomState(0).randn(2, 9, 10, 5).astype(np.float32)
    jm = jlayers.ConvBNLeaky(8, kernel=kernel, stride=stride)
    v = random_variables(jm, x, seed=1)
    tm = bridged(layers.ConvBNLeaky(5, 8, kernel=kernel, stride=stride), v)
    with torch.no_grad():
        ours = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(ours, np.asarray(jax_apply(jm, v, x)), **TOL)


def test_upsample2x_and_leaky():
    x = np.random.RandomState(2).randn(2, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(layers.upsample2x(nchw(x))), np.asarray(jlayers.upsample2x(jnp.asarray(x)))
    )
    np.testing.assert_allclose(
        layers.leaky(torch.from_numpy(x)).numpy(), np.asarray(jlayers.leaky(jnp.asarray(x))),
        rtol=1e-6, atol=0,
    )


def test_darknet_basic_block():
    x = np.random.RandomState(3).randn(2, 6, 6, 8).astype(np.float32)
    jm = jdarknet.DarknetBasicBlock(4)
    v = random_variables(jm, x, seed=4)
    tm = bridged(darknet.DarknetBasicBlock(4), v)
    with torch.no_grad():
        ours = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(ours, np.asarray(jax_apply(jm, v, x)), **TOL)


def test_narrow_darknet53_pad_stem():
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    jm = jdarknet.Darknet53(pad_stem=True, **NARROW)
    v = random_variables(jm, x, seed=6)
    assert v["params"]["conv0"]["Conv_0"]["kernel"].shape == (3, 3, 4, 8)
    tm = bridged(darknet.Darknet53(pad_stem=True, **NARROW), v)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    ref = jax_apply(jm, v, x)
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def _routes(seed, b=2, size=64, channels=(16, 32, 64)):
    rs = np.random.RandomState(seed)
    return tuple(
        rs.randn(b, size // s, size // s, c).astype(np.float32)
        for s, c in zip((8, 16, 32), channels)
    )


@pytest.mark.parametrize("agnostic", [False, True])
def test_head_no_backbone(agnostic):
    routes = _routes(7)
    jm = jyolo3.YOLOv3(num_classes=3, use_backbone=False, channels=HEAD, agnostic=agnostic)
    v = random_variables(jm, routes, seed=8)
    tm = bridged(
        yolo3.YOLOv3(
            num_classes=3, use_backbone=False, channels=HEAD, agnostic=agnostic,
            route_channels=(16, 32, 64),
        ),
        v,
    )
    with torch.no_grad():
        boxes, scores = tm(tuple(torch.from_numpy(r) for r in routes))
    rb, rsc = jax_apply(jm, v, routes)
    n = 3 * (8 * 8 + 4 * 4 + 2 * 2)
    assert boxes.shape == (2, n, 4) and scores.shape == (2, n, 1 if agnostic else 3)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(rb), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(rsc), **TOL)


def test_head_return_levels_and_postprocess_levels():
    routes = _routes(9)
    jm = jyolo3.YOLOv3(num_classes=3, use_backbone=False, channels=HEAD, return_levels=True)
    v = random_variables(jm, routes, seed=10)
    tm = bridged(
        yolo3.YOLOv3(
            num_classes=3, use_backbone=False, channels=HEAD, return_levels=True,
            route_channels=(16, 32, 64),
        ),
        v,
    )
    with torch.no_grad():
        ours = tm(tuple(torch.from_numpy(r) for r in routes))
    ref = jax_apply(jm, v, routes)
    for (ob, os_), (rb, rsc) in zip(ours, ref):
        np.testing.assert_allclose(ob.numpy(), np.asarray(rb), **TOL)
        np.testing.assert_allclose(os_.numpy(), np.asarray(rsc), **TOL)
    # the levels path from the SAME level tensors: identical detections
    jlev = tuple((jnp.asarray(b.numpy()), jnp.asarray(s.numpy())) for b, s in ours)
    for a, r in zip(yolo3.postprocess_levels(ours), jyolo3.postprocess_levels(jlev)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def _tie_free(seed, b=2, n=300, c=5):
    """Boxes and scores where every score is distinct (the top-k is exact
    only modulo ties)."""
    rs = np.random.RandomState(seed)
    scores = ((rs.permutation(b * n * c) + 1) / (b * n * c + 1)).astype(np.float32)
    xy = rs.rand(b, n, 2).astype(np.float32) * 100
    wh = rs.rand(b, n, 2).astype(np.float32) * 60 + 2
    return np.concatenate([xy, xy + wh], -1), scores.reshape(b, n, c)


@pytest.mark.parametrize(
    "nms_thresh,nms_topk,force", [(0.45, 400, False), (0.45, 100, True), (1.0, 400, False)]
)
def test_postprocess_tie_free(nms_thresh, nms_topk, force):
    boxes, scores = _tie_free(11)
    ours = yolo3.postprocess(
        torch.from_numpy(boxes), torch.from_numpy(scores), nms_thresh=nms_thresh,
        nms_topk=nms_topk, force_suppress=force,
    )
    ref = jyolo3.postprocess(
        jnp.asarray(boxes), jnp.asarray(scores), nms_thresh=nms_thresh,
        nms_topk=nms_topk, force_suppress=force,
    )
    for a, r in zip(ours, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    assert (ours[0].numpy() >= 0).sum() > 10  # NMS kept real detections


def test_select_topk_candidates_and_flatten():
    boxes, scores = _tie_free(12, n=40, c=3)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    ours = yolo3.select_topk_candidates(tb, ts, topk=50)
    ref = jyolo3.select_topk_candidates(jnp.asarray(boxes), jnp.asarray(scores), topk=50)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        yolo3.flatten_detections(tb, ts).numpy(),
        np.asarray(jyolo3.flatten_detections(jnp.asarray(boxes), jnp.asarray(scores))),
    )
    with pytest.raises(NotImplementedError):
        yolo3.select_topk_candidates(tb, ts, approx_recall=0.95)


def _match_detections(ours, ref, margin_floor):
    """Detections (ids, scores, boxes), one image: every row scored at least
    1e-3 above `margin_floor` on either side has a partner on the other with
    the same id and score and box within 1e-3 (rows are compared as sets:
    near-equal scores may order differently)."""
    pick = lambda d: [  # noqa: E731
        (int(i), np.concatenate([[s], b]))
        for i, s, b in zip(d[0].ravel(), d[1].ravel(), d[2]) if i >= 0 and s >= margin_floor
    ]
    a, r = pick(ours), pick(ref)
    assert len(a) == len(r) and len(a) > 0
    unused = list(range(len(r)))
    for i, row in a:
        hit = next(
            (u for u in unused if r[u][0] == i and np.abs(r[u][1] - row).max() < 1e-3), None
        )
        assert hit is not None, (i, row)
        unused.remove(hit)


def test_slice_end_to_end_narrow():
    """Narrow backbone -> head -> postprocess, both packages."""
    x = np.random.RandomState(13).randn(2, 64, 64, 3).astype(np.float32)
    jb = jdarknet.Darknet53(pad_stem=True, **NARROW)
    jh = jyolo3.YOLOv3(num_classes=4, use_backbone=False, channels=HEAD)
    vb = random_variables(jb, x, seed=14)
    routes = jax_apply(jb, vb, x)
    vh = random_variables(jh, routes, seed=15)
    rb, rsc = jax_apply(jh, vh, routes)
    ref = jyolo3.postprocess(rb, rsc)
    cands = np.asarray(jyolo3.select_topk_candidates(rb, rsc))

    tb = bridged(darknet.Darknet53(pad_stem=True, **NARROW), vb)
    th = bridged(
        yolo3.YOLOv3(num_classes=4, use_backbone=False, channels=HEAD, route_channels=(32, 32, 64)),
        vh,
    )
    with torch.no_grad():
        boxes, scores = th(tb(torch.from_numpy(x)))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(rb), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(rsc), **TOL)
    ours = yolo3.postprocess(boxes, scores)
    for b in range(2):
        kth = cands[b, -1, 1]  # the K-th candidate's score
        _match_detections(
            [o[b].numpy() for o in ours], [np.asarray(r[b]) for r in ref],
            max(kth, 0.01) + 1e-3,
        )


def test_full_width_yolov3_128px():
    """One full-width YOLOv3(num_classes=20, pad_stem=True) at 128 px in
    float32, to the narrow models' tolerance.  Kernel gain 0.5 keeps the
    random activations in range: at gain 1 the residual sums grow through
    the 23 blocks until the exp of the box decode reaches 1e11 px."""
    x = np.random.RandomState(16).randn(1, 128, 128, 3).astype(np.float32)
    jm = jyolo3.YOLOv3(num_classes=20, pad_stem=True)
    v = random_variables(jm, x, seed=17, gain=0.5)
    tm = yolo3_darknet53(20, pad_stem=True)
    missing, unexpected = tm.load_state_dict(flax_to_state_dict(v), strict=True)
    assert not missing and not unexpected
    with torch.no_grad():
        boxes, scores = tm.eval()(torch.from_numpy(x))
    rb, rsc = jax_apply(jm, v, x)
    assert boxes.shape == rb.shape == (1, 3 * (16 * 16 + 8 * 8 + 4 * 4), 4)
    assert np.isfinite(boxes.numpy()).all()
    np.testing.assert_allclose(boxes.numpy(), np.asarray(rb), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(rsc), **TOL)


def test_bf16_narrow():
    """bf16 on both sides.  Tolerance 0.01 absolute on scores, and 1.5 px
    plus 2% on boxes (up to 211 px here): bf16 keeps 8 bits of mantissa
    (4e-3 relative rounding per op), the two frameworks round at different
    places (flax normalises BN in float32 before the cast, torch's CPU convs
    round once per output), and the error compounds over 39 convs and the
    exp of the box decode.  Measured: 0.0014 on scores, 0.88 px on boxes."""
    x = np.random.RandomState(18).randn(2, 64, 64, 3).astype(np.float32)
    jb = jdarknet.Darknet53(pad_stem=True, dtype=jnp.bfloat16, **NARROW)
    jh = jyolo3.YOLOv3(num_classes=4, use_backbone=False, channels=HEAD, dtype=jnp.bfloat16)
    vb = random_variables(jb, x, seed=19)
    routes = jax_apply(jb, vb, x)
    vh = random_variables(jh, routes, seed=20)
    rb, rsc = jax_apply(jh, vh, routes)

    bf16 = torch.bfloat16
    tb = bridged(darknet.Darknet53(pad_stem=True, dtype=bf16, **NARROW), vb)
    th = bridged(
        yolo3.YOLOv3(
            num_classes=4, use_backbone=False, channels=HEAD, route_channels=(32, 32, 64), dtype=bf16
        ),
        vh,
    )
    with torch.no_grad():
        troutes = tb(torch.from_numpy(x))
        assert all(r.dtype == bf16 for r in troutes)
        boxes, scores = th(troutes)
    assert boxes.dtype == scores.dtype == torch.float32  # the decode runs in float32
    np.testing.assert_allclose(boxes.numpy(), np.asarray(rb), rtol=0.02, atol=1.5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(rsc), rtol=0, atol=0.01)


def test_factory_surface():
    m = build_model(YoloConfig(num_classes=20, pad_stem=True, dtype=torch.bfloat16))
    assert m.backbone.conv0.Conv_0.weight.shape == (32, 4, 3, 3)
    # float32 master parameters, the conv computed in bf16 (flax's nn.Conv)
    assert m.backbone.conv0.Conv_0.weight.dtype == torch.float32
    assert m.backbone.conv0.Conv_0.dtype == m.output0.prediction.dtype == torch.bfloat16
    assert m.backbone.conv0.BatchNorm_0.running_var.dtype == torch.float32
    assert m.output0.anchors.dtype == torch.float32
    head = yolo3_no_backbone(["a", "b"])
    assert not head.use_backbone and head.output2.num_classes == 2
    # the new_model family and the FlowNet and R(2+1)D two-stream models
    # build (tests/test_torch_backbones.py, tests/test_torch_flownet.py,
    # tests/test_torch_r21d.py)
    with torch.device("meta"):
        assert build_model(YoloConfig(num_classes=2, new_model=True)).has_backbone
        assert build_model(YoloConfig(num_classes=2, k=3, motion_stream="flownet")).has_backbone
        assert build_model(YoloConfig(num_classes=2, k=9, motion_stream="r21d")).backbone.stream == "r21d"
    # the output conv-RNN builds (tests/test_torch_rnn.py), but not after an
    # early correlation
    assert type(build_model(YoloConfig(num_classes=2, k=3, rnn_pos="out")).output0).__name__ == "YOLOOutputRNN"
    with pytest.raises(ValueError, match="not built"):
        build_model(YoloConfig(num_classes=2, k=3, rnn_pos="out", corr_pos="early", corr_d=2))
    # slice 4 builds the s2d stem and remat, and trains the 2D model
    s2d = build_model(YoloConfig(num_classes=2, s2d_stem=True, remat="stem"))
    assert s2d.backbone.conv0.Conv_0.weight.shape == (128, 12, 3, 3)
    assert s2d.backbone.stage1.ConvBNLeaky_0.Conv_0.weight.shape == (64, 128, 2, 2)
    assert s2d.backbone.remat_stages == 3 and build_model(YoloConfig(num_classes=2, remat=True)).remat
    assert m(torch.zeros(1, 32, 32, 3))["bbox"].shape == (1, 63, 4)  # train mode
    # YOLOv3T trains (ROADMAP.md Queue 1 item 16); with per-frame heads (no
    # join) its train mode gives them a time axis, as JAX's does, and the
    # per-timestep loss (item 8) takes per-timestep gt
    assert build_model(YoloConfig(num_classes=2, k=3))(torch.zeros(1, 3, 32, 32, 3))["bbox"].shape == (1, 63, 4)
    assert type(build_model(YoloConfig(num_classes=2, temporal=True))).__name__ == "YOLOv3Temporal"
    tm = YOLOv3T(num_classes=2, k=3)
    assert tm(torch.zeros(1, 3, 32, 32, 3))["bbox"].shape == (1, 3, 63, 4)  # train mode
    with pytest.raises(ValueError, match="per-timestep gt"):
        make_train_step(tm, num_classes=2)(create_train_state(tm, lambda step: 0.0), {
            "image": torch.zeros(1, 3, 32, 32, 3), "gt_boxes": torch.full((1, 1, 4), -1.0),
            "gt_ids": torch.full((1, 1, 1), -1.0)})
    metrics = make_train_step(tm, num_classes=2)(create_train_state(tm, lambda step: 0.0), {
        "image": torch.zeros(1, 3, 32, 32, 3), "gt_boxes": torch.full((1, 3, 1, 4), -1.0),
        "gt_ids": torch.full((1, 3, 1, 1), -1.0)})
    assert bool(torch.isfinite(metrics["total"]))
