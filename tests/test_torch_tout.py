"""The port's YOLOv3Temporal (t=5) serving path against the JAX package's,
on the CPU: the kernel_size=3 correlation as the card computes it (the
kernel_size=1 volume, then the patch sum, with the plain volume standing in
for K2 and the plain adjoint for K2's), its gradient, the pyramid's Corr
layer, ConvBNLeaky3D, the model on its three paths and at t=1, the factory
and the weight bridge, `Detector` on windows of 5, and the detect twin's
per-offset caches read by detect_yolo3.py.

Inputs are made with numpy from a seed and handed to both packages; weights
are random flax variables carried across by the flax bridge.  Tolerances:
the correlation and its gradient within rtol 1e-5 / atol 1e-6 of JAX's (the
same products, summed in another order: the port divides by C before the
patch sum), the float32 models within 1e-4 (other conv algorithms)."""
import functools
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli_datasets import _jax_env
from test_torch_temporal import random_variables
from test_torch_vid import write_vid_tree
from videoyolo_tpu.data.transforms import to_normalized as jax_to_normalized
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.factory import YoloConfig as JaxYoloConfig
from videoyolo_tpu.models.factory import build_model as jax_build_model
from videoyolo_tpu.models.yolo3 import postprocess_tout as jax_postprocess_tout
from videoyolo_tpu.models.yolo3 import select_topk_candidates as jax_select
from videoyolo_tpu.models.yolo3_temporal import YOLOv3Temporal as JaxYOLOv3Temporal
from videoyolo_tpu.ops.correlation import correlation as jax_correlation
from videoyolo_torch import detect
from videoyolo_torch.models import layers
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.yolo3_temporal import YOLOv3Temporal
from videoyolo_torch.ops import correlation_kernel as k
from videoyolo_torch.ops.correlation import CostVolume, correlation, correlation_plain, patch_correlation
from videoyolo_torch.serving import Detector
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CORR_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 64
T = 5


def plain_volume(f1, f2, d, stride2):
    """K2's function on the CPU: the kernel_size=1 volume."""
    return correlation_plain(f1, f2, d, 1, 1, stride2)


# --- the kernel_size=3 correlation ------------------------------------------

# (d, B, H, W, C): d 0-4, odd sizes
COMPOSED = [(0, 2, 7, 6, 3), (1, 1, 5, 9, 4), (2, 2, 7, 6, 3), (3, 1, 11, 7, 5), (4, 2, 13, 11, 8), (4, 1, 6, 6, 16)]


@functools.lru_cache(maxsize=None)
def _jax_k3(d):
    return jax.jit(partial(jax_correlation, max_displacement=d, kernel_size=3, stride1=1, stride2=1))


@pytest.mark.parametrize("same", [False, True], ids=["f1_f2", "f1_is_f2"])
@pytest.mark.parametrize("d,b,h,w,c", COMPOSED, ids=[f"d{d}_{h}x{w}x{c}" for d, _, h, w, c in COMPOSED])
def test_composed_route_matches_plain_and_xla(d, b, h, w, c, same):
    """The card's route for kernel_size=3 (the kernel_size=1 volume, the
    3x3 patch sum zero-padded by 1, a divide by 9) with the plain volume in
    K2's place, against `correlation_plain(kernel_size=3)` and JAX's XLA
    form, including f1 and f2 one tensor (the middle frame against
    itself)."""
    rs = np.random.RandomState(d * 10 + h)
    a = rs.randn(b, h, w, c).astype(np.float32)
    bb = a if same else rs.randn(b, h, w, c).astype(np.float32)
    f1, f2 = torch.from_numpy(a), torch.from_numpy(bb)
    if same:
        f2 = f1
    got = patch_correlation(plain_volume, f1, f2, d, 3)
    plain = correlation_plain(f1, f2, d, 3, 1, 1)
    ref = np.asarray(_jax_k3(d)(a, bb))
    assert got.shape == plain.shape == ref.shape == (b, h, w, (2 * d + 1) ** 2)
    torch.testing.assert_close(got, plain, **CORR_TOL)
    np.testing.assert_allclose(got.numpy(), ref, **CORR_TOL)
    # on the CPU `correlation` keeps the plain version
    assert torch.equal(correlation(f1, f2, d, kernel_size=3, stride1=1, stride2=1), plain)


@pytest.mark.parametrize("same", [False, True], ids=["f1_f2", "f1_is_f2"])
@pytest.mark.parametrize("d,b,h,w,c", COMPOSED[1:5], ids=[f"d{d}_{h}x{w}x{c}" for d, _, h, w, c in COMPOSED[1:5]])
def test_composed_route_gradient_matches_jax_vjp(d, b, h, w, c, same):
    """The gradient of the composed route through `CostVolume` (its CPU
    adjoint, `cost_volume_backward_plain`, where the card runs K2's adjoint
    kernel) and the patch sum's autograd, against `jax.vjp` of the XLA
    form; with f1 and f2 one tensor, the sum of both gradients."""
    rs = np.random.RandomState(100 + d)
    a, bb = rs.randn(b, h, w, c), rs.randn(b, h, w, c)
    g = rs.randn(b, h, w, (2 * d + 1) ** 2)
    f1 = torch.tensor(a, dtype=torch.float32, requires_grad=True)
    f2 = f1 if same else torch.tensor(bb, dtype=torch.float32, requires_grad=True)
    out = patch_correlation(CostVolume.apply, f1, f2, d, 3)
    (out * torch.tensor(g, dtype=torch.float32)).sum().backward()
    fn = _jax_k3(d)
    if same:
        _, vjp = jax.vjp(lambda x: fn(x, x), a.astype(np.float32))
        (ref1,) = vjp(g.astype(np.float32))
        np.testing.assert_allclose(f1.grad.numpy(), np.asarray(ref1), **CORR_TOL)
    else:
        _, vjp = jax.vjp(fn, a.astype(np.float32), bb.astype(np.float32))
        ref1, ref2 = vjp(g.astype(np.float32))
        np.testing.assert_allclose(f1.grad.numpy(), np.asarray(ref1), **CORR_TOL)
        np.testing.assert_allclose(f2.grad.numpy(), np.asarray(ref2), **CORR_TOL)


def test_corr_layer_pyramid_matches_jax():
    """Corr(d, 5, kernel_size=3, keep='none', comp_mid=True): (B, 5, H, W,
    D), each frame against the middle one and the middle one against
    itself; and its gradient (the window's) against jax.vjp."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, T, 9, 7, 6).astype(np.float32)
    jc = jlayers.Corr(2, T, kernel_size=3, stride=1, keep="none", comp_mid=True)
    ref, vjp = jax.vjp(lambda z: jc.apply({}, z), x)
    layer = layers.Corr(2, T, kernel_size=3, stride=1, keep="none", comp_mid=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    assert out.shape == ref.shape == (2, T, 9, 7, 25)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **CORR_TOL)
    g = rs.randn(*out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(g)[0]), **CORR_TOL)


def test_kernel_entries_refuse_cpu_tensors():
    """The card's route takes CUDA tensors only: the kernel entries raise
    on CPU tensors and nothing is launched."""
    f = torch.zeros(1, 6, 6, 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        k.cost_volume(f, f, 2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        k.cost_volume_backward(torch.zeros(1, 6, 6, 25), f, f, 2)
    assert k.cost_volume.launches == k.cost_volume_backward.launches == 0


# the pyramid's volumes at 416 px (52x52x256, d=4): B=16 and B=1 windows in
# detection, B=8 in training; (B, forward plan's (R, gx, gy, threads, grid),
# the adjoint's (R, slab, threads, grid))
PYRAMID_PLANS = [
    (16, (2, 9, 3, 32, (49, 3, 16)), (2, 256, 64, (49, 2, 16))),
    (8, (2, 9, 3, 32, (49, 3, 8)), (2, 256, 64, (49, 2, 8))),
    (1, (1, 9, 1, 64, (49, 9, 1)), (2, 48, 64, (49, 12, 1))),
]


@pytest.mark.parametrize("b,fwd,bwd", PYRAMID_PLANS, ids=[f"B{p[0]}" for p in PYRAMID_PLANS])
def test_plans_of_the_pyramid(b, fwd, bwd):
    """The plans K2 and its adjoint take at the pyramid's shapes: 16-byte
    copies (the middle frame against itself is one aligned tensor), a
    launch that fills the card, the adjoint's whole grid in one group."""
    pl = k.plan(b, 52, 52, 256, 4, 1, True)
    assert (pl.r, pl.gx, pl.gy, pl.threads, pl.grid) == fwd and pl.copy == 16 and pl.smem <= k.SMEM_BYTES
    assert pl.ctas >= k.SMS
    bp = k.plan_backward(b, 52, 52, 256, 4, 1, True)
    assert (bp.r, bp.slab, bp.threads, bp.grid) == bwd and (bp.gx, bp.gy, bp.copy) == (9, 9, 16)
    assert bp.ctas >= 2 * k.SMS and bp.slab % k.CHUNK == 0
    window = torch.zeros(b, T, 52, 52, 256)
    mid = window[:, T // 2]
    assert k.aligned(mid, mid) and k.aligned(window[:, 0], mid)


# --- ConvBNLeaky3D ------------------------------------------------------------

CELLS3D = {
    "spatial": dict(kernel=(1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1)),
    "temporal": dict(kernel=(3, 1, 1), stride=(1, 1, 1), padding=(0, 0, 0)),
    "default_pad": dict(kernel=(3, 3, 3), stride=(1, 1, 1), padding=None),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(CELLS3D))
def test_conv_bn_leaky_3d_matches_flax(name, train):
    """The 3-D cell in eval mode (running statistics) and train mode (the
    batch's, over frames and pixels; the running statistics updated as
    flax's 0.9 / 0.1 blend of the biased variance)."""
    kw = CELLS3D[name]
    rs = np.random.RandomState(3)
    x = rs.randn(2, T, 9, 10, 6).astype(np.float32)
    jm = jlayers.ConvBNLeaky3D(8, **kw)
    v = jax.tree_util.tree_map(np.asarray, random_variables(jm, x, seed=4))
    cell = layers.ConvBNLeaky3D(6, 8, **kw)
    cell.load_state_dict(flax_to_state_dict(v), strict=True)
    cell.train(train)
    out = cell(torch.from_numpy(x))
    if train:
        ref, mutated = jm.apply(v, x, train=True, mutable=["batch_stats"])
        stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])})
        for key, want in stats.items():
            if not key.endswith("num_batches_tracked"):
                torch.testing.assert_close(cell.state_dict()[key], want.float(), rtol=1e-5, atol=1e-6)
    else:
        ref = jm.apply(v, x, train=False)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    # the int8 3-D cell (item 9a, tests/test_torch_int8_temporal.py)
    qcell = layers.ConvBNLeaky3D(6, 8, quant="dynamic")
    assert qcell.qkernel.shape == (8, 6, 3, 3, 3) and qcell.qkernel.dtype == torch.int8 and qcell.calib == {}
    with pytest.raises(ValueError, match="3-D int8 cells"):
        layers.ConvBNLeaky3D(6, 8, quant="fused")


def test_conv3d_takes_channels_last_with_the_model():
    """`model.to(memory_format=torch.channels_last)`, as the entry points
    convert models, leaves the 3-D kernels 5-D in channels_last_3d memory
    (torch raises on a 5-D tensor in channels_last) and the outputs
    unchanged."""
    cell = layers.ConvBNLeaky3D(4, 8, kernel=(3, 1, 1), padding=(0, 0, 0)).eval()
    x = torch.randn(2, 3, 5, 5, 4)
    before = cell(x)
    cell.to(torch.float64, memory_format=torch.channels_last)
    w = cell.Conv_0.weight
    assert w.dtype == torch.float64 and w.dim() == 5 and w.is_contiguous(memory_format=torch.channels_last_3d)
    cell.float()
    torch.testing.assert_close(cell(x), before)


# --- YOLOv3Temporal -----------------------------------------------------------

PATHS = {
    "pyramid": dict(t_out=True, corr_d=2),
    "per_frame": dict(t_out=True),
    "funnel": dict(t_out=False),
    "t1": dict(t=1),
    "pyramid_agnostic": dict(t_out=True, corr_d=2, agnostic=True),
}


def _input(name, b=2, size=SIZE):
    t = PATHS[name].get("t", T)
    shape = (b, t, size, size, 3) if t > 1 else (b, size, size, 3)
    return np.random.RandomState(20).randint(0, 256, shape).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """(variables, uint8 input, JAX eval outputs) of YOLOv3Temporal(4
    classes, PATHS[name]) at 64 px, B=2; kernel gain 0.5."""
    jm = JaxYOLOv3Temporal(num_classes=4, **PATHS[name])
    x = _input(name)
    v = jax.tree_util.tree_map(np.asarray, random_variables(jm, jax_to_normalized(x), seed=21, gain=0.5))
    out = jax.jit(lambda v, x: jm.apply(v, jax_to_normalized(x), train=False))(v, x)
    return v, x, tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("name", list(PATHS))
def test_yolov3_temporal_matches_flax(name):
    """Eval outputs on each path against flax at float32: (B, 5, N, .)
    per frame on the t_out paths, (B, N, .) on the funnel and at t=1."""
    v, x, (rb, rs_) = _jax_model(name)
    tm = YOLOv3Temporal(num_classes=4, **PATHS[name])
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        boxes, scores = tm.eval()(torch.from_numpy(np.asarray(jax_to_normalized(x))))
    n = 3 * sum((SIZE // s) ** 2 for s in (8, 16, 32))
    lead = (2, T) if PATHS[name].get("t_out") and "t" not in PATHS[name] else (2,)
    classes = 1 if PATHS[name].get("agnostic") else 4
    assert boxes.shape == rb.shape == lead + (n, 4) and scores.shape == rs_.shape == lead + (n, classes)
    assert tm.path == {"pyramid_agnostic": "pyramid", "t1": "single"}.get(name, name)
    np.testing.assert_allclose(boxes.numpy(), rb, **TOL)
    np.testing.assert_allclose(scores.numpy(), rs_, **TOL)


@pytest.mark.parametrize("name", ["pyramid", "funnel"])
def test_yolov3_temporal_train_mode_heads_keep_time(name):
    """Train mode returns the raw-head dict, with the time axis kept on the
    t_out paths (the shapes of flax's), and boxes as flax's."""
    v, x, _ = _jax_model(name)
    jm = JaxYOLOv3Temporal(num_classes=4, **PATHS[name])
    ref, _ = jm.apply(v, jax_to_normalized(x), train=True, mutable=["batch_stats"])
    tm = YOLOv3Temporal(num_classes=4, **PATHS[name])
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    out = tm.train()(torch.from_numpy(np.asarray(jax_to_normalized(x))))
    assert {key: tuple(o.shape) for key, o in out.items()} == {key: r.shape for key, r in ref.items()}
    # train-mode BN normalises the deepest level over 40 values a channel
    # (10 frames of 2x2 pixels) and amplifies rounding: measured 8.6e-5 of
    # the largest box coordinate
    got, want = out["bbox"].detach().numpy(), np.asarray(ref["bbox"])
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


FACTORY = {
    "bench_t5": (dict(temporal=True, t_out=True, corr_pos="early", corr_d=4), "pyramid"),
    "t_out": (dict(temporal=True, t_out=True), "per_frame"),
    "mult_out_only": (dict(t_out=True, corr_d=2), "pyramid"),
    "funnel": (dict(temporal=True), "funnel"),
    "t1": (dict(temporal=True, k=1), "single"),
}


@pytest.mark.parametrize("name", list(FACTORY))
def test_factory_branch_and_bridge_both_ways(name):
    """The factory's `temporal or t_out` branch (t = k or 5, conv from
    block_conv_type, corr_d or 0) builds the JAX factory's parameters, leaf
    for leaf through the bridge; a port state_dict goes to flax variables
    of JAX's tree and back bit for bit (the 3-D kernels (kt, kh, kw, I, O)
    <-> (O, I, kt, kh, kw))."""
    cfg, path = FACTORY[name]
    jm = jax_build_model(JaxYoloConfig(num_classes=3, **cfg))
    t = 1 if cfg.get("k") == 1 else T
    x = jnp.zeros((1, t, SIZE, SIZE, 3) if t > 1 else (1, SIZE, SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), x)
    tm = build_model(YoloConfig(num_classes=3, **cfg))
    assert isinstance(tm, YOLOv3Temporal) and tm.path == path
    layers.init_weights(tm, torch.Generator().manual_seed(2))
    back = state_dict_to_flax(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(shapes)
    assert all(a.shape == s.shape for a, s in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(shapes)))
    again = flax_to_state_dict(back)
    for key, t_ in tm.state_dict().items():
        assert torch.equal(again[key].to(t_.dtype), t_), key
    if path == "funnel":
        assert back["params"]["convs1_s"]["Conv_0"]["kernel"].shape == (1, 3, 3, 256, 256)
        assert tm.convs2_t.Conv_0.weight.shape == (1024, 512, 3, 1, 1)


def test_factory_raises_on_unported_axes():
    # the 3-D blocks build on the t_out paths (tests/test_torch_blocks3d.py);
    # the 3-D funnel, whose JAX forward mixes a batch's images, raises
    with torch.device("meta"):
        assert build_model(YoloConfig(num_classes=2, t_out=True, block_conv_type="21")).path == "per_frame"
    with pytest.raises(ValueError, match="not built"):
        build_model(YoloConfig(num_classes=2, temporal=True, block_conv_type="21"))
    # the streaming split is ported (tests/test_torch_streaming.py): feed="stage1"
    # builds the pyramid's head over stage-1 windows, everything but stage 1
    with torch.device("meta"):
        stage1_head = YOLOv3Temporal(num_classes=2, corr_d=2, feed="stage1")
    assert {key.split(".")[0] for key in stage1_head.state_dict()} >= {"stage2", "stage3", "convs1", "block0"}
    assert not any(key.startswith("stage1.") for key in stage1_head.state_dict())
    # the static and dynamic modes are ported (item 9a,
    # tests/test_torch_int8_temporal.py); the fused pipeline is YOLOv3's
    with pytest.raises(ValueError, match="fused pipeline is YOLOv3's"):
        YOLOv3Temporal(num_classes=2, quant="fused")
    with pytest.raises(ValueError, match="t=1 or t=5"):
        YOLOv3Temporal(num_classes=2, t=3)


@pytest.mark.parametrize("name", ["pyramid", "funnel"])
def test_detector_on_t5_windows_matches_jax(name):
    """`Detector` on uint8 windows of 5 against JAX's apply and
    `postprocess_tout`: per-frame detections (B, 5, 100, .) on the pyramid
    (one NMS call on the B*5 frames), (B, 100, .) on the funnel; rows
    compared as sets where scored 1e-3 clear of the K-th candidate and the
    valid threshold (tests/test_torch_serving.py's rule)."""
    v, x, _ = _jax_model(name)
    jm = JaxYOLOv3Temporal(num_classes=4, **PATHS[name])

    @jax.jit
    def step(v, x):
        boxes, scores = jm.apply(v, jax_to_normalized(x), train=False)
        ids, sc, bb = jax_postprocess_tout(boxes, scores, nms_thresh=0.45, nms_topk=400)
        flat = lambda a: a.reshape((-1,) + a.shape[-2:])  # noqa: E731
        return ids, sc, bb.clip(0, SIZE), jax_select(flat(boxes), flat(scores))

    rids, rsc, rbb, cands = (np.asarray(a) for a in step(v, x))
    cfg = YoloConfig(num_classes=4, temporal=True, **{k_: v_ for k_, v_ in PATHS[name].items() if k_ != "t"})
    det = Detector(cfg, v, data_shape=SIZE, device="cpu")
    ids, sc, bb = (a.numpy() for a in det(x))
    lead = (2, T) if name == "pyramid" else (2,)
    assert ids.shape == rids.shape == lead + (100, 1) and bb.shape == lead + (100, 4)
    assert bb.min() >= 0 and bb.max() <= SIZE
    ids, sc, bb, rids, rsc, rbb = (a.reshape((-1,) + a.shape[-2:]) for a in (ids, sc, bb, rids, rsc, rbb))
    matched = 0
    for i in range(ids.shape[0]):
        floor = max(cands[i, -1, 1], 0.01) + 1e-3
        pick = lambda i_, s_, x_: [  # noqa: E731
            (int(c), np.concatenate([[p], q])) for c, p, q in zip(i_.ravel(), s_.ravel(), x_) if c >= 0 and p >= floor]
        ours, ref = pick(ids[i], sc[i], bb[i]), pick(rids[i], rsc[i], rbb[i])
        assert len(ours) == len(ref)
        unused = list(range(len(ref)))
        for c, row in ours:
            hit = next(u for u in unused if ref[u][0] == c and np.abs(ref[u][1] - row).max() < 1e-3)
            unused.remove(hit)
        matched += len(ours)
    assert matched > 0
    with pytest.raises(ValueError, match="expected images"):
        det(x[:, :3])


def test_detect_entry_point_temporal_flags_on_cpu(capsys):
    """`python -m videoyolo_torch.detect --temp --mult_out --window 5,1
    --corr_pos early --corr_d 2` on seeded windows: detections for each
    frame of each window; `--temp` alone (the funnel) one set a window."""
    base = ["--data_shape", str(SIZE), "--batch_size", "2", "--num_requests", "1", "--device", "cpu", "--dtype", "f32",
            "--window", "5,1"]
    preds = detect.main(base + ["--temp", "--mult_out", "--corr_pos", "early", "--corr_d", "2"])
    assert sorted(preds) == [f"request0/window{i:04d}_o{t}" for i in range(2) for t in range(T)]
    for entries in preds.values():
        assert all(len(e) == 6 and 0 <= min(e[2:]) and max(e[2:]) <= 1 for e in entries)
    preds = detect.main(base + ["--temp"])
    assert sorted(preds) == ["request0/window0000", "request0/window0001"]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("request")]
    assert len(lines) == 2 and all("/window" in ln for ln in lines)


# --- the detect twin's per-offset caches ----------------------------------------

MULT_OUT = ("--every", "4", "--window", "5,1", "--temp", "--mult_out", "--corr_pos", "early", "--corr_d", "2")


def _absl(extra):
    """argparse flags as absl ones: `--every 4` -> `--every=4`, booleans kept."""
    out, it = [], iter(extra)
    for a in it:
        out.append(a if a in ("--temp", "--mult_out") else f"{a}={next(it)}")
    return out


@pytest.mark.parametrize("offset", [0, -2])
def test_detect_twin_mult_out_caches_read_by_jax(tmp_path, offset):
    """The detect twin on VID windows of 5 with --temp --mult_out: one cache
    directory a window offset (pred_o0..pred_o4), each frame under its own
    `<video>/<frame>` name, a frame clamped onto the key frame at a video's
    ends written under the key frame only; detect_yolo3.py with the same
    flags reads the cache (no model) and writes the same vid.txt and
    voc.txt for the evaluated `--offset`; a second run reads the cache."""
    root = write_vid_tree(str(tmp_path / "tree"), seed=8, gaps=False)
    save_dir = tmp_path / "results"
    flags = [*MULT_OUT, "--offset", str(offset)]
    argv = ["--dataset", "vid", "--dataset_root", root, "--data_shape", str(SIZE), "--batch_size", "4",
            "--device", "cpu", "--save_dir", str(save_dir), "--save_prefix", "port", "--num_workers", "2",
            "--metrics", "vid,voc", *flags]
    preds = detect.main(argv)
    out = save_dir / "port"
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("pred")) == [f"pred_o{t}" for t in range(T)]
    assert isinstance(preds, list) and len(preds) == T and all(len(p) for p in preds)
    # window i of a video takes frames i-2..i+2 clamped: offset t holds frame i+t-2 of each window
    video = "ILSVRC2015_val_00000000"
    first = sorted(f.name for f in (out / "pred_o0" / video).glob("*.txt"))
    assert first == [f"{i:06d}.txt" for i in (0, 2, 6)]  # the windows of frames 0, 4, 8: frame 0 clamped onto itself
    assert (out / "pred_o0" / video / "000000.txt").read_text() == ""
    assert (out / "pred_o2" / video / "000000.txt").read_text() != ""
    ours = {m: (out / f"{m}.txt").read_text() for m in ("vid", "voc")}
    for m in ours:
        (out / f"{m}.txt").unlink()
    r = subprocess.run(
        [sys.executable, "detect_yolo3.py", "--dataset=vid", f"--dataset_root={root}", f"--save_dir={save_dir}",
         "--save_prefix=port", f"--data_shape={SIZE}", "--metrics=vid,voc", *_absl(flags)],
        cwd=REPO, env=_jax_env(), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    assert "randomly initialised" not in r.stderr
    for m in ours:
        assert (out / f"{m}.txt").read_text() == ours[m], m
    again = detect.main(argv)
    assert [set(a) for a in again] == [set(p) for p in preds]
