"""Slice 4 (training) against the JAX package on the CPU, module by module:
the targets, the losses, the color maps, the lr schedules, the s2d stem,
train-mode BatchNorm and its running statistics, the train-mode YOLOv3
heads, rematerialisation, and the float32 master parameters of the serving
slices.

Inputs are numpy arrays made from a seed; weights are random flax variables
carried across by the bridge (tests/test_torch_models.py:random_variables).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import HEAD, NARROW, TOL, nchw, nhwc, random_variables
from videoyolo_tpu.models import darknet as jdarknet
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models import s2d as js2d
from videoyolo_tpu.models import yolo3 as jyolo3
from videoyolo_tpu.ops import color as jcolor
from videoyolo_tpu.ops import losses as jlosses
from videoyolo_tpu.ops import targets as jtargets
from videoyolo_tpu.train import lr as jlr
from videoyolo_torch.models import darknet, layers, s2d, yolo3
from videoyolo_torch.models.factory import YoloConfig
from videoyolo_torch.ops import color, losses, targets
from videoyolo_torch.serving import Detector
from videoyolo_torch.train import lr
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict

torch.set_num_threads(2)

HW = (64, 96)  # a non-square input: the grid's H and W must not swap


def _gts(seed, b=3, m=7, c=5, hw=HW):
    """Padded gt rows with collisions (two gts on one slot, in both orders),
    centers on the right and bottom edges, and padding rows."""
    rs = np.random.RandomState(seed)
    h, w = hw
    boxes = np.full((b, m, 4), -1, np.float32)
    ids = np.full((b, m, 1), -1, np.float32)
    for i in range(b):
        n = m - 2  # the last two rows stay padding
        xy = rs.rand(n, 2) * [w - 30, h - 30]
        wh = rs.rand(n, 2) * 40 + 4
        boxes[i, :n] = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1)
        ids[i, :n, 0] = rs.randint(0, c, n)
    # image 0: rows 0 and 1 on one slot (same center and size), row 0 first
    boxes[0, 1] = boxes[0, 0] + [0.5, 0.5, -0.5, -0.5]
    # image 1: the same pair, later row first (the later gt wins either way)
    boxes[1, 0] = boxes[1, 1] + [0.5, 0.5, -0.5, -0.5]
    # image 2: centers exactly on the right and on the bottom edge
    boxes[2, 0] = [w - 20, 10, w + 20, 30]
    boxes[2, 1] = [10, h - 12, 30, h + 12]
    boxes[2, 2] = [w - 8, h - 8, w, h]
    return boxes, ids


def _assert_targets_equal(ours, ref):
    """Every target equal bit for bit, but the scale targets (index 2):
    log(w / anchor), where XLA:CPU's float32 log is its own approximation
    (correctly rounded for about 92% of inputs, torch's for 99.98%), so
    those are held to one ulp."""
    for k, (a, r) in enumerate(zip(ours, ref)):
        assert a.dtype == torch.float32 and a.shape == r.shape
        if k == 2:
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(r), maxulp=1)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def _prefetch_both(boxes, ids, mix=None, c=5, hw=HW):
    ours = targets.prefetch_targets(
        torch.from_numpy(boxes), torch.from_numpy(ids), None if mix is None else torch.from_numpy(mix),
        input_hw=hw, num_classes=c,
    )
    ref = jtargets.prefetch_targets(
        jnp.asarray(boxes), jnp.asarray(ids), None if mix is None else jnp.asarray(mix),
        input_hw=hw, num_classes=c,
    )
    return ours, ref


def test_flat_layout():
    for a, r in zip(targets.flat_layout(HW), jtargets.flat_layout(HW)):
        np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("multi_hot", [False, True])
def test_prefetch_targets_exact(multi_hot):
    boxes, ids = _gts(0)
    if multi_hot:
        rs = np.random.RandomState(1)
        ids = (rs.rand(*ids.shape[:2], 5) > 0.6).astype(np.float32)
    ours, ref = _prefetch_both(boxes, ids)
    _assert_targets_equal(ours, ref)
    obj = ours[0].numpy()
    # the collisions leave one target each; the edge centers land in the last cells
    assert obj[0].sum() == obj[1].sum() == 4 and obj[2].sum() == 5


def test_prefetch_targets_later_gt_wins():
    boxes, ids = _gts(0)
    ids[:2, :5, 0] = 0
    ids[:2, 0, 0], ids[:2, 1, 0] = 1, 3
    ours, ref = _prefetch_both(boxes, ids)
    cls = ours[4].numpy()
    for i in (0, 1):  # row 1 is the later one in both images
        assert (cls[i, :, 3] == 1).sum() == 1 and (cls[i, :, 1] == 1).sum() == 0
    np.testing.assert_array_equal(cls, np.asarray(ref[4]))


def test_prefetch_targets_mixup():
    boxes, ids = _gts(2)
    mix = np.random.RandomState(3).uniform(0.2, 1.0, ids.shape).astype(np.float32)
    ours, ref = _prefetch_both(boxes, ids, mix)
    _assert_targets_equal(ours, ref)
    assert set(np.unique(ours[0].numpy())) <= {0.0} | set(mix.ravel().tolist())


@pytest.mark.parametrize("label_smooth", [False, True])
def test_merge_targets_exact(label_smooth):
    boxes, ids = _gts(4)
    mix = np.random.RandomState(5).uniform(0.2, 1.0, ids.shape).astype(np.float32)
    ours, ref = _prefetch_both(boxes, ids, mix)
    n = ours[0].shape[1]
    rs = np.random.RandomState(6)
    # predictions near the gts, so the ignore mask has entries
    src = boxes[:, rs.randint(0, 5, n)]
    preds = (src + rs.randn(*src.shape) * 2).astype(np.float32)
    got = targets.merge_targets(
        torch.from_numpy(preds), torch.from_numpy(boxes), *ours, num_classes=5, label_smooth=label_smooth
    )
    want = jtargets.merge_targets(
        jnp.asarray(preds), jnp.asarray(boxes), *ref, num_classes=5, label_smooth=label_smooth
    )
    assert not any(a.requires_grad for a in got)
    _assert_targets_equal(got[:5], want[:5])
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    assert (got[0].numpy() == -1).sum() > 0  # ignored anchors


def test_losses():
    rs = np.random.RandomState(7)
    b, n, c = 2, 50, 4
    preds = [rs.randn(b, n, k).astype(np.float32) * 3 for k in (1, 2, 2, c)]
    obj_t = rs.choice([-1.0, 0.0, 0.0, 0.6, 1.0], (b, n, 1)).astype(np.float32)
    tgts = [obj_t, rs.rand(b, n, 2).astype(np.float32), rs.randn(b, n, 2).astype(np.float32),
            rs.uniform(1, 2, (b, n, 2)).astype(np.float32), rs.choice([-1.0, 0.0, 1.0], (b, n, c)).astype(np.float32),
            (rs.rand(b, n, c) > 0.3).astype(np.float32)]
    got = losses.yolo3_loss(*map(torch.from_numpy, preds + tgts))
    want = jlosses.yolo3_loss(*map(jnp.asarray, preds + tgts))
    assert set(got) == set(want) == {"obj", "center", "scale", "cls"}
    for k in got:
        assert got[k].shape == (b,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    p, y, w = (torch.from_numpy(a) for a in (preds[3], tgts[4], tgts[5]))
    np.testing.assert_allclose(losses.sigmoid_bce(p, y, w).numpy(),
                               np.asarray(jlosses.sigmoid_bce(*map(jnp.asarray, (preds[3], tgts[4], tgts[5])))),
                               rtol=1e-6)
    np.testing.assert_allclose(losses.weighted_l1(p, y, w).numpy(),
                               np.asarray(jlosses.weighted_l1(*map(jnp.asarray, (preds[3], tgts[4], tgts[5])))),
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 9, 7, 3), (2, 3, 5, 4, 3)])
def test_apply_color(shape):
    rs = np.random.RandomState(8)
    x = rs.randint(0, 256, shape).astype(np.uint8)
    mat = rs.randn(shape[0], 3, 4).astype(np.float32)
    got = color.apply_color(torch.from_numpy(x), torch.from_numpy(mat))
    want = jcolor.apply_color(jnp.asarray(x), jnp.asarray(mat))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="4D/5D"):
        color.apply_color(torch.zeros(2, 3, 3), torch.from_numpy(mat))


@pytest.mark.parametrize("mode,warmup,kw", [
    ("step", 0, dict(lr_decay_epochs=(2, 4))), ("step", 1, dict(lr_decay_epochs=(2, 4), lr_decay=0.5)),
    ("poly", 2, {}), ("poly", 0.5, dict(warmup_lr=1e-4)), ("cosine", 0, {}), ("cosine", 0.1, {}),
    ("constant", 0, {}), ("constant", 1.5, {}),
])
def test_lr_schedule(mode, warmup, kw):
    base = 1e-3
    ours = lr.lr_schedule(mode, base, steps_per_epoch=40, epochs=6, warmup_epochs=warmup, **kw)
    ref = jlr.lr_schedule(mode, base, steps_per_epoch=40, epochs=6, warmup_epochs=warmup, **kw)
    steps = list(range(0, 250, 3)) + [40, 80, 160, 239, 240, 241]
    got = np.array([float(ours(s)) for s in steps], np.float32)
    want = np.array([float(ref(s)) for s in steps], np.float32)
    assert ours(0).dtype == torch.float32
    # cosine: float32 cos differs by 1 ulp between XLA and torch, and near
    # the end of the schedule the lr is a difference of nearly equal terms,
    # so there the tolerance is 1e-6 of the base lr
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * base if mode == "cosine" else 0)


def test_refold_kernels_equal_jax():
    rs = np.random.RandomState(9)
    w0 = rs.randn(3, 3, 3, 8).astype(np.float32)
    w1 = rs.randn(3, 3, 8, 16).astype(np.float32)
    np.testing.assert_array_equal(s2d.refold_conv0(w0), js2d.refold_conv0(w0))
    np.testing.assert_array_equal(s2d.refold_down1(w1), js2d.refold_down1(w1))


def _narrow_darknets(seed):
    x = np.random.RandomState(seed).randn(2, 32, 32, 3).astype(np.float32)
    std = jdarknet.Darknet53(**NARROW)
    v = random_variables(std, x, seed=seed + 1)
    return x, v, jdarknet.Darknet53(s2d_stem=True, **NARROW)


def test_refold_stem_s2d_gives_standard_outputs():
    x, v, js2d_model = _narrow_darknets(10)
    refolded = s2d.refold_stem_s2d(v)
    for a, r in zip(jax.tree_util.tree_leaves(refolded), jax.tree_util.tree_leaves(js2d.refold_stem_s2d(v))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
    # the bridge's names for the refolded leaves
    state = flax_to_state_dict(refolded)
    assert state["conv0.Conv_0.weight"].shape == (32, 12, 3, 3)
    assert state["stage1.ConvBNLeaky_0.Conv_0.weight"].shape == (16, 32, 2, 2)
    assert state["conv0.BatchNorm_0.weight"].shape == (8,)
    std = darknet.Darknet53(**NARROW)
    std.load_state_dict(flax_to_state_dict(v))
    folded = darknet.Darknet53(s2d_stem=True, **NARROW)
    folded.load_state_dict(state)
    with torch.no_grad():
        ref = std.eval()(torch.from_numpy(x))
        ours = folded.eval()(torch.from_numpy(x))
    want = jax.jit(partial(js2d_model.apply, train=False))(refolded, x)
    for o, r, w in zip(ours, ref, want):
        np.testing.assert_allclose(o.numpy(), r.numpy(), **TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(w), **TOL)


def _jax_train_apply(module, variables, x):
    return jax.jit(partial(module.apply, train=True, mutable=["batch_stats"]))(variables, x)


def test_s2d_stem_train_statistics():
    """ConvBNLeakyS2D's statistics pool the 4 phases: equal to JAX's, and to
    the standard stem's on the same image (the JAX docstring's claim)."""
    x = np.random.RandomState(12).randn(2, 16, 16, 3).astype(np.float32) * 3 + 1
    jstd = jlayers.ConvBNLeaky(8)
    v = random_variables(jstd, x, seed=13)
    vs = {"params": {"Conv_0": {"kernel": js2d.refold_conv0(np.asarray(v["params"]["Conv_0"]["kernel"]))},
                     "BatchNorm_0": v["params"]["BatchNorm_0"]},
          "batch_stats": v["batch_stats"]}
    cell = darknet.ConvBNLeakyS2D(12, 8)
    cell.load_state_dict(flax_to_state_dict(vs))
    std = layers.ConvBNLeaky(3, 8)
    std.load_state_dict(flax_to_state_dict(v))
    xs = darknet.space_to_depth(torch.from_numpy(x))
    y = cell.train()(nchw(xs.numpy()))
    y_std = std.train()(nchw(x))
    jcell = jdarknet.ConvBNLeakyS2D(8)
    jy, jmut = _jax_train_apply(jcell, vs, np.asarray(jdarknet.space_to_depth(jnp.asarray(x))))
    np.testing.assert_allclose(nhwc(y), np.asarray(jy), **TOL)
    for ours, name in ((cell.BatchNorm_0, "BatchNorm_0"),):
        np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(jmut["batch_stats"][name]["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(jmut["batch_stats"][name]["var"]), rtol=1e-5, atol=1e-6)
    # the same statistics as the standard stem, and the same output, phase by phase
    np.testing.assert_allclose(cell.BatchNorm_0.running_mean.numpy(), std.BatchNorm_0.running_mean.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cell.BatchNorm_0.running_var.numpy(), std.BatchNorm_0.running_var.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(darknet.space_to_depth(torch.from_numpy(nhwc(y_std))).numpy(), nhwc(y), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_statistics_biased(dtype):
    """Train mode on the same input: the output and the running statistics
    equal flax's BatchNorm(momentum=0.9, epsilon=1e-5), whose statistics
    are float32 reductions even of bf16 inputs and whose running variance
    takes the biased batch variance."""
    from flax import linen as fnn

    rs = np.random.RandomState(14)
    x = jnp.asarray((rs.randn(3, 5, 4, 6) * 2 + 0.5).astype(np.float32), getattr(jnp, dtype))
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=getattr(jnp, dtype))
    rv = np.random.RandomState(15)
    v = {"params": {"scale": rv.uniform(0.5, 1.5, 6).astype(np.float32), "bias": rv.randn(6).astype(np.float32)},
         "batch_stats": {"mean": rv.randn(6).astype(np.float32), "var": rv.uniform(0.5, 1.5, 6).astype(np.float32)}}
    bn = layers.BatchNorm(6)
    bn.load_state_dict(flax_to_state_dict(v))
    xt = nchw(np.asarray(x, np.float32)).to(getattr(torch, dtype))
    y = bn.train()(xt)
    jy, mut = jax.jit(partial(jm.apply, mutable=["batch_stats"]))(v, x)
    assert y.dtype == xt.dtype
    tol = TOL if dtype == "float32" else dict(rtol=0.01, atol=0.02)  # one bf16 rounding
    np.testing.assert_allclose(nhwc(y.float()), np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), rtol=1e-6)
    # the biased batch variance, not torch's unbiased one
    ra_var = torch.from_numpy(np.asarray(v["batch_stats"]["var"]))
    x32 = xt.float()
    biased, unbiased = x32.var(dim=(0, 2, 3), unbiased=False), x32.var(dim=(0, 2, 3))
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 * ra_var + 0.1 * biased).numpy(), rtol=1e-5)
    assert not np.allclose(bn.running_var.numpy(), (0.9 * ra_var + 0.1 * unbiased).numpy(), rtol=1e-3)
    # eval mode and the frozen recompute of remat leave the statistics alone
    before = bn.running_var.clone()
    with torch.no_grad():
        bn.eval()(xt)
    with layers.frozen_stats(bn):
        bn.train()(xt)
    assert torch.equal(before, bn.running_var)


def _assert_stats(model, batch_stats, **tol):
    ours = model.state_dict()
    for path, want in _leaves(batch_stats):
        key = ".".join(path[:-1] + ({"mean": "running_mean", "var": "running_var"}[path[-1]],))
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(want), **tol)


def test_darknet53_train_routes_and_statistics():
    x = np.random.RandomState(16).randn(2, 64, 64, 3).astype(np.float32)
    jm = jdarknet.Darknet53(**NARROW)
    v = random_variables(jm, x, seed=17)
    tm = darknet.Darknet53(**NARROW)
    tm.load_state_dict(flax_to_state_dict(v))
    routes = tm.train()(torch.from_numpy(x))
    ref, mut = _jax_train_apply(jm, v, x)
    for o, r in zip(routes, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **TOL)
    _assert_stats(tm, mut["batch_stats"], rtol=1e-4, atol=1e-5)


def test_yolov3_train_heads_and_statistics():
    """Train-mode YOLOv3 head (float32): the raw heads deep -> shallow and
    the batch_stats after the forward, against JAX's."""
    routes = tuple(np.random.RandomState(18).randn(2, 64 // s, 64 // s, c).astype(np.float32)
                   for s, c in zip((8, 16, 32), (16, 32, 64)))
    jm = jyolo3.YOLOv3(num_classes=3, use_backbone=False, channels=HEAD)
    v = random_variables(jm, routes, seed=19)
    tm = yolo3.YOLOv3(num_classes=3, use_backbone=False, channels=HEAD, route_channels=(16, 32, 64))
    tm.load_state_dict(flax_to_state_dict(v))
    out = tm.train()(tuple(torch.from_numpy(r) for r in routes))
    ref, mut = _jax_train_apply(jm, v, routes)
    assert set(out) == set(ref) == {"bbox", "raw_centers", "raw_scales", "objness", "class_pred"}
    for k in out:
        assert out[k].dtype == torch.float32 and out[k].shape == ref[k].shape
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **TOL)
    _assert_stats(tm, mut["batch_stats"], rtol=1e-4, atol=1e-5)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _grads_and_stats(model, x):
    out = model.train()(x)
    (out["objness"].sum() + out["raw_scales"].pow(2).sum() + out["class_pred"].sum()).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}
    return grads, stats


@pytest.mark.parametrize("remat", [True, "stem"])
def test_remat_same_statistics_and_gradients(remat):
    """jax's remat is pure: the recompute in the backward pass must leave
    the BN running statistics as the forward left them, and the gradients
    must not change."""
    x = torch.from_numpy(np.random.RandomState(20).randn(2, 64, 64, 3).astype(np.float32))
    plain = yolo3.YOLOv3(num_classes=3)
    layers.init_weights(plain, torch.Generator().manual_seed(21))
    rematted = yolo3.YOLOv3(num_classes=3, remat=remat)
    rematted.load_state_dict(plain.state_dict())
    g0, s0 = _grads_and_stats(plain, x)
    g1, s1 = _grads_and_stats(rematted, x)
    assert s0.keys() == s1.keys() and g0.keys() == g1.keys()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6)
    bn = rematted.backbone.stage1.ConvBNLeaky_0.BatchNorm_0
    assert not bn.frozen and not torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))


def test_darknet53_classifier():
    x = np.random.RandomState(22).randn(2, 32, 32, 3).astype(np.float32)
    jm = jdarknet.Darknet53Classifier(classes=10)
    v = random_variables(jm, x, seed=23)
    tm = darknet.Darknet53Classifier(classes=10)
    tm.load_state_dict(flax_to_state_dict(v))
    assert tm.Dense_0.weight.shape == (10, 1024)
    with torch.no_grad():
        ours = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax.jit(partial(jm.apply, train=False))(v, x)), **TOL)


def _legacy_bf16_weights(model):
    """The serving slices' models as they were: conv weights stored in bf16
    (the float32 masters rounded once, as a bf16 nn.Conv2d's load did)."""
    for m in model.modules():
        if isinstance(m, layers.Conv2d) and m.dtype == torch.bfloat16:
            m.weight.data = m.weight.data.to(torch.bfloat16)
            if m.bias is not None:
                m.bias.data = m.bias.data.to(torch.bfloat16)


@pytest.mark.parametrize("slice_", ["slice1", "slice2", "slice3"])
def test_float32_masters_keep_serving_outputs(slice_):
    """The serving slices' bf16 detections, bit for bit, whether the conv
    weights are float32 masters cast at each call or bf16 as stored before."""
    rs = np.random.RandomState(24)
    if slice_ == "slice2":
        cfg = YoloConfig(num_classes=20, k=3, k_join_pos="late", corr_pos="early", corr_d=4)
        images = rs.randint(0, 256, (2, 3, 64, 64, 3)).astype(np.uint8)
    else:
        cfg = YoloConfig(num_classes=20, pad_stem=True)
        images = rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    kw = dict(quantize="int8", calibration=[images]) if slice_ == "slice3" else {}
    det = Detector(cfg, dtype=torch.bfloat16, data_shape=64, device="cpu", **kw)
    first, again = det(images), det(images)  # the second call reads the cast cache
    _legacy_bf16_weights(det.model)
    legacy = det(images)
    for a, b, c in zip(first, again, legacy):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (first[0] >= 0).sum() > 0


def _opt_tree():
    """A module tree with the scopes the optimizer masks read: a base scope
    ("backbone"), a head cell and a prediction conv with a bias."""
    tree = torch.nn.Module()
    tree.backbone = layers.ConvBNLeaky(3, 4)
    tree.block0 = layers.ConvBNLeaky(4, 4, kernel=1)
    tree.output0 = torch.nn.Module()
    tree.output0.prediction = layers.Conv2d(4, 6, 1, bias=True)
    layers.init_weights(tree, torch.Generator().manual_seed(25))
    return tree


@pytest.mark.parametrize("no_wd_bn,freeze_base", [(False, False), (True, False), (False, True), (True, True)])
def test_optimizer_equals_optax_three_steps(no_wd_bn, freeze_base):
    """add_decayed_weights then sgd(momentum) then the freeze mask, under a
    warmup whose first step has lr 0, against torch's SGD as the port sets
    it up; then `fast_forward_schedule` and one more step."""
    import optax
    from videoyolo_tpu.train import step as jstep
    from videoyolo_torch.train import step as tstep
    from videoyolo_torch.utils.flax_bridge import state_dict_to_flax

    tree = _opt_tree()
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(tree.state_dict())["params"])
    sched = dict(mode="step", base_lr=0.1, steps_per_epoch=2, epochs=6, warmup_epochs=1, lr_decay_epochs=(2,))
    tx = jstep.make_optimizer(jlr.lr_schedule(**sched), no_wd_bn=no_wd_bn, freeze_base=freeze_base)
    opt_state = tx.init(params)
    state = tstep.create_train_state(tree, lr.lr_schedule(**sched), no_wd_bn=no_wd_bn, freeze_base=freeze_base)
    rs = np.random.RandomState(26)
    names = dict(tree.named_parameters())
    for i in range(4):
        if i == 3:
            opt_state = jstep.fast_forward_schedule(opt_state, 7)
            tstep.fast_forward_schedule(state, 7)
        grads = {k: rs.randn(*p.shape).astype(np.float32) for k, p in names.items()}
        for k, p in names.items():
            p.grad = torch.from_numpy(grads[k])
        state.apply_gradients()
        jgrads = jax.tree_util.tree_map(
            jnp.asarray, state_dict_to_flax({k: torch.from_numpy(g) for k, g in grads.items()})["params"])
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
    ours = state_dict_to_flax(tree.state_dict())["params"]
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, params)))
    assert ref.keys() == dict(_leaves(ours)).keys()
    for path, a in _leaves(ours):
        np.testing.assert_allclose(a, ref[path], rtol=1e-6, atol=1e-7, err_msg="/".join(path))
    base = tree.backbone.Conv_0.weight
    assert state.step == 8 and (freeze_base == torch.equal(base, _opt_tree().backbone.Conv_0.weight))
