"""The conv-RNN (ROADMAP.md Queue 1 item 5) against the JAX package on the
CPU: the cells (`ConvGRUCell`, `ConvLSTMCell` through `ConvRNN`, one and
two directions), YOLOv3T with the tip conv-RNN (`rnn_pos="late"`, with the
late max join and with the late correlation) and with the output conv-RNN
(`rnn_pos="out"`), their streams, the `feed="tips"` head of the output
conv-RNN, one float64 train step through the tip conv-RNN and the late
correlation, the refusals beside the JAX package's failure, and the twins'
`--rnn_pos`.

Inputs are numpy arrays from a seed; the models run at 64 px with narrow
FPN channels (16, 8, 4) over the full Darknet-53, three classes, from
random flax variables carried across by the bridge.  Detections are held
within rtol=atol=1e-4 as tests/test_torch_streaming.py holds them (rows
against their own magnitude, near-tied rows in either order).  On the CPU
the port takes the plain NMS and the plain correlation; the card's kernels
are held by chip_smoke.py's phase 17."""
import functools
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_streaming import _bridged_keys, assert_dets_close, assert_head_close
from test_torch_train_temporal import _Float64Jnp
from videoyolo_tpu import streaming as jstreaming
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.yolo3 import postprocess_tout as jax_postprocess_tout
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.models.yolo3_temporal import YOLOv3Temporal as JaxYOLOv3Temporal
from videoyolo_tpu.train import lr as jlr
from videoyolo_tpu.train import step as jstep
from videoyolo_torch import detect, streaming
from videoyolo_torch.models import layers
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.yolo3 import postprocess_tout
from videoyolo_torch.models.yolo3_temporal import YOLOv3T, YOLOv3Temporal
from videoyolo_torch.streaming import StreamingDetector
from videoyolo_torch.train import lr, step
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax, walk
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)
from torch_heap import trim_heap

torch.set_num_threads(2)

S, NC = 64, 3
CH = (16, 8, 4)
MODELS = {
    "rnn-late": dict(k=3, k_join_type="max", k_join_pos="late", rnn_pos="late"),
    # the factory's defaults: no early join runs before the output GRU
    "rnn-out": dict(k=3, k_join_type="mean", k_join_pos="early", rnn_pos="out"),
    "rnn-late-corr": dict(k=3, k_join_pos="late", rnn_pos="late", corr_pos="late", corr_d=2),
}
SPLITS = {"rnn-late": "routes", "rnn-out": "tips", "rnn-late-corr": "routes"}


# --- shared helpers (tests/test_torch_blocks3d.py imports them) -------------

def classes(kw):
    return (JaxYOLOv3Temporal, YOLOv3Temporal) if "t" in kw else (JaxYOLOv3T, YOLOv3T)


def window_len(kw):
    return kw.get("k") or kw["t"]


def frames(n, seed, b=1):
    rs = np.random.RandomState(seed)
    return [rs.rand(b, S, S, 3).astype(np.float32) for _ in range(n)]


def fill_random(shapes, seed):
    """Random variables in `shapes`: kernels N(0, 1/fan_in), BN scale and
    variance in [0.5, 1.5], the rest N(0, 0.01) (as the port's other
    tests draw them)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.standard_normal(shape, np.float32) / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.standard_normal(shape, np.float32) * np.float32(0.1)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def jax_input(kw, feed=None):
    k = window_len(kw)
    if feed == "tips":
        return tuple(jnp.zeros((1, k, S // s, S // s, 2 * c), jnp.float32) for s, c in zip((32, 16, 8), CH))
    return jnp.zeros((1, k, S, S, 3), jnp.float32)


@functools.lru_cache(maxsize=None)
def shapes_of(key, feed=None):
    kw = dict(key)
    jm = classes(kw)[0](num_classes=NC, channels=CH, feed=feed, **kw)
    return jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), jax_input(kw, feed))


def models(kw, seed):
    """(JAX model, its variables, the port's model on them in eval mode)."""
    jcls, tcls = classes(kw)
    variables = fill_random(shapes_of(tuple(sorted(kw.items()))), seed)
    tm = tcls(num_classes=NC, channels=CH, **kw)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jcls(num_classes=NC, channels=CH, **kw), variables, tm.eval()


@functools.lru_cache(maxsize=None)
def jax_windowed(key):
    """JAX's apply and postprocess_tout on a window, jitted once a
    configuration."""
    jm = classes(dict(key))[0](num_classes=NC, channels=CH, **dict(key))
    return jax.jit(lambda v, x: jax_postprocess_tout(*jm.apply(v, x, train=False)))


def check_model_and_stream(kw, split, seed):
    """The port's windowed forward and its stream (reset and k steps, the
    window of each step left-padded with the first frame) against JAX's
    apply and postprocess on the same windows; the stream takes `split`.
    JAX compiles and runs in a thread while the port runs."""
    key = tuple(sorted(kw.items()))
    _, variables, tm = models(kw, seed)
    k = window_len(kw)
    fs = frames(k + 1, seed)
    windows = [np.stack([fs[max(0, j)] for j in range(i - k + 1, i + 1)], axis=1) for i in range(k + 1)]
    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(lambda: [jax.device_get(jax_windowed(key)(variables, jnp.asarray(w))) for w in windows])
        with torch.no_grad():
            boxes, scores = tm(torch.from_numpy(windows[-1]))
        stream = StreamingDetector(tm)
        dets = [stream.reset(torch.from_numpy(fs[0]))] + [stream.step(torch.from_numpy(f)) for f in fs[1:]]
        refs = refs.result()
    assert boxes.dtype == scores.dtype == torch.float32
    assert_dets_close(postprocess_tout(boxes, scores), refs[-1])
    assert stream.split == split and stream.k == k
    for got, want in zip(dets, refs):
        assert_dets_close(got, want)


def check_splits(kw):
    """The split, the per-frame half's names and `split_temporal_variables`
    are JAX's for the configuration."""
    jm = classes(kw)[0](num_classes=NC, channels=CH, **kw)
    with torch.device("meta"):
        tm = classes(kw)[1](num_classes=NC, channels=CH, **kw)
    assert streaming._tip_split_ok(tm) == jstreaming._tip_split_ok(jm)
    assert streaming._embed_names(tm) == jstreaming._embed_names(jm)
    names = jstreaming._TIP_NAMES if jstreaming._tip_split_ok(jm) else jstreaming._embed_names(jm)
    assert streaming.split_names(tm) == names
    shapes = shapes_of(tuple(sorted(kw.items())))
    state = dict.fromkeys(_bridged_keys(shapes))
    assert state.keys() == tm.state_dict().keys()
    jembed, jhead = jstreaming.split_temporal_variables(shapes, names)
    embed, head = streaming.split_temporal_variables(state, names)
    assert set(embed) == _bridged_keys(jembed) and set(head) == _bridged_keys(jhead)


def batch_mixes_in_jax(jm, variables, x) -> float:
    """How far JAX's scores of the first image of a batch of two move when
    the second image changes (0 for a model that keeps a batch's images
    apart): the batches (x0, x1) and (x0, x0), one compile."""
    apply = jax.jit(partial(jm.apply, train=False))
    _, pair = apply(variables, jnp.asarray(x))
    _, same = apply(variables, jnp.asarray(np.concatenate([x[:1], x[:1]])))
    return float(jnp.abs(pair[0] - same[0]).max())


# float64 train step: one step from the same weights, the cost volumes in
# float64 on both sides (tests/test_torch_train_temporal.py's tolerances)
LR = dict(mode="step", base_lr=1e-2, steps_per_epoch=10, epochs=3)


def _train_batch(k, seed):
    rs = np.random.RandomState(seed)
    clip = rs.randint(0, 256, (k, S, S, 3)).astype(np.uint8)
    gtb = np.full((1, 6, 4), -1, np.float64)
    gti = np.full((1, 6, 1), -1, np.float64)
    gtb[0, :2] = [[5, 6, 40, 50], [20, 2, 60, 30]]
    gti[0, :2, 0] = [1, 2]
    color = np.concatenate([np.eye(3) * 2.0**-6 + np.roll(np.eye(3), 1, 1) * 2.0**-10, np.full((3, 1), -2.0)], -1)
    return {"image": clip[None], "color": color[None], "gt_boxes": gtb, "gt_ids": gti}


def _jax_train_step(jm, variables, batch):
    """JAX's float64 step from `variables`: (the bridged state after it, the
    metrics)."""
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx = jstep.make_optimizer(jlr.lr_schedule(**LR))
        state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                 batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        # LLVM's level 1 compiles the step in two thirds of the default's time
        fn = jax.jit(jstep.make_train_step(jm, num_classes=NC)).lower(state, jb).compile(
            compiler_options={"xla_backend_optimization_level": 1})
        state, metrics = fn(state, jb)
        ref = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
        return {k: t.double() for k, t in ref.items()}, {k: float(m) for k, m in metrics.items()}


def check_train_step_float64(kw, seed):
    """One float64 train step of the port against `jax.jit(make_train_step)`:
    the losses within rtol 1e-6, each updated leaf within 1e-5 of its
    largest update, the running statistics within rtol 1e-5, atol 1e-6.
    JAX's step runs first and its state is freed before the port's (the
    float64 full-width model and its optimizer take gigabytes)."""
    jcls, tcls = classes(kw)
    variables = fill_random(shapes_of(tuple(sorted(kw.items()))), seed)
    batch = _train_batch(window_len(kw), seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "jnp", _Float64Jnp())
        mp.setattr(layers, "CORR_DTYPE", torch.float64)
        ref, jmetrics = _jax_train_step(jcls(num_classes=NC, channels=CH, **kw), variables, batch)
        jax.clear_caches()
        trim_heap()
        tm = tcls(num_classes=NC, channels=CH, dtype=torch.float64, **kw).double()
        tm.load_state_dict({k: t.double() if t.is_floating_point() else t
                            for k, t in flax_to_state_dict(variables).items()})
        del variables
        v0 = {k: t.detach().clone() for k, t in tm.state_dict().items()}
        metrics = step.make_train_step(tm, num_classes=NC)(
            step.create_train_state(tm, lr.lr_schedule(**LR)), {k: torch.from_numpy(a) for k, a in batch.items()})
    for k, m in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), m, rtol=1e-6, err_msg=k)
    ours = tm.state_dict()
    # the trained state goes back to JAX's tree, leaf for leaf (a checkpoint's way)
    back = {path: a.shape for path, a in walk(state_dict_to_flax(ours))}
    assert back == {tuple(k.key for k in path): leaf.shape
                    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes_of(tuple(sorted(kw.items()))))}
    for k, r in ref.items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(ours[k], r, rtol=1e-5, atol=1e-6, msg=k)
        elif not k.endswith("num_batches_tracked"):
            d_ref = r - v0[k]
            err = float(((ours[k] - v0[k]) - d_ref).abs().max())
            assert err <= 1e-5 * max(float(d_ref.abs().max()), 1e-30), (k, err)
    return ours, v0


# --- the cells ---------------------------------------------------------------

CELL_TOL = {np.float64: 1e-10, np.float32: 1e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("bi", [True, False], ids=["bi", "one-way"])
@pytest.mark.parametrize("type_", ["gru", "lstm"])
def test_conv_rnn_matches_flax(type_, bi, dtype):
    """`ConvRNN` (B=2, T=3, 6x5 frames, 4 -> 5 channels, 3x3) against flax's
    on the same variables: every step's output, both directions averaged
    for `bi`; the carry starts at zeros in the input's dtype."""
    rs = np.random.RandomState(2 * ["gru", "lstm"].index(type_) + bi)
    x = rs.randn(2, 3, 6, 5, 4).astype(dtype)
    jm = jlayers.ConvRNN(5, kernel=(3, 3), type=type_, bi=bi)
    with jax.enable_x64(dtype == np.float64):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
        v = jax.tree_util.tree_map(lambda a: a.astype(dtype), fill_random(shapes, 3))
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tm = layers.ConvRNN(4, 5, kernel=(3, 3), type=type_, bi=bi, dtype=tdtype).to(tdtype)
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    assert [k for k in tm.state_dict()][:2] == ["fwd.i2h.weight", "fwd.i2h.bias"]
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == tdtype and got.shape == want.shape == (2, 3, 6, 5, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CELL_TOL[dtype])


def test_conv_rnn_bf16_and_single_cells():
    """The bf16 GRU (float32 masters, the convs and the gates in bf16) within
    bf16 rounding of flax's; `ConvGRUCell` and `ConvLSTMCell` alone, one
    step from a given carry, against flax's cells in float32; the 1x1 GRU of
    the output head; a bad type raises."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 3, 6, 5, 4).astype(np.float32)
    jm = jlayers.ConvRNN(6, kernel=(1, 1), dtype=jnp.bfloat16)
    v = fill_random(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    want = np.asarray(jm.apply(v, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tm = layers.ConvRNN(4, 6, kernel=(1, 1), dtype=torch.bfloat16)
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and tm.fwd.i2h.weight.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=0.05)
    h = rs.randn(2, 6, 5, 5).astype(np.float32)
    c = rs.randn(2, 6, 5, 5).astype(np.float32)
    for jcell, tcell, carry in ((jlayers.ConvGRUCell(5), layers.ConvGRUCell(4, 5), (h[..., :5],)),
                                (jlayers.ConvLSTMCell(5), layers.ConvLSTMCell(4, 5), (h[..., :5], c[..., :5]))):
        jc = carry[0] if len(carry) == 1 else carry
        xf = x[:, 0]
        v = fill_random(jax.eval_shape(jcell.init, jax.random.PRNGKey(0), jc, jnp.asarray(xf)), 5)
        want = jcell.apply(v, jc, jnp.asarray(xf))
        tcell.load_state_dict(flax_to_state_dict(v), strict=True)
        nchw = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))) for a in carry]
        with torch.no_grad():
            got = tcell(nchw[0] if len(nchw) == 1 else tuple(nchw), torch.from_numpy(xf).permute(0, 3, 1, 2))
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="gru"):
        layers.ConvRNN(4, 5, type="rnn")


# --- the models ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_yolov3t_rnn_and_stream_match_jax(name):
    """YOLOv3T with the conv-RNN against JAX's apply and postprocess: the
    windowed forward on a window, and the stream (rnn out on the tip split,
    its output GRUs scanning the window of tips; rnn late on the route
    split) at every step of reset and k steps."""
    check_model_and_stream(MODELS[name], SPLITS[name], seed=1)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rnn_splits_match_jax(name):
    check_splits(MODELS[name])


def test_rnn_names_and_factory():
    """The modules carry the flax names (`tip_rnn{i}.{fwd,bwd}.{i2h,h2h}`,
    `output{i}.prediction.{fwd,bwd}...`), the blocks of rnn late have no tip
    cell, and the factory builds both arms (its default join is early, which
    the output GRU skips)."""
    with torch.device("meta"):
        late = build_model(YoloConfig(num_classes=NC, k=3, k_join_pos="late", rnn_pos="late"))
        out = build_model(YoloConfig(num_classes=NC, k=3, rnn_pos="out"))
    keys = late.state_dict().keys()
    assert "tip_rnn0.fwd.i2h.weight" in keys and "tip_rnn2.bwd.h2h.bias" in keys
    assert late.tip_rnn0.fwd.i2h.weight.shape == (3 * 1024, 512, 3, 3)
    assert late.tip_rnn0.fwd.h2h.weight.shape == (3 * 1024, 1024, 3, 3)
    assert not any(k.startswith("block0._TCell_5") for k in keys) and late.late_join
    assert out.output0.prediction.fwd.i2h.weight.shape == (3 * 3 * (5 + NC), 1024, 1, 1)
    assert not (out.early_join or out.late_join or out.late_corr) and out.output0.pool.type == "max"


def test_rnn_late_corr_train_step_float64_matches_jax():
    """One float64 step of rnn late + the late correlation (the gradient
    through the cost volumes of the tip GRU's outputs, then the GRU, the
    blocks and the stages) against JAX's step; the stem learns."""
    ours, v0 = check_train_step_float64(MODELS["rnn-late-corr"], seed=2)
    assert float((ours["stage1.conv0.Conv_0.weight"] - v0["stage1.conv0.Conv_0.weight"]).abs().max()) > 0
    assert float((ours["tip_rnn2.bwd.h2h.weight"] - v0["tip_rnn2.bwd.h2h.weight"]).abs().max()) > 0


def test_rnn_out_feed_head_holds_jax_head_variables():
    """`feed="tips"` with rnn out holds exactly JAX's feed clone's variables
    (the bridge of JAX's head split loads with strict=True), and its forward
    on the stream's tip buffers equals the windowed forward."""
    kw = MODELS["rnn-out"]
    _, variables, tm = models(kw, seed=5)
    _, head_vars = jstreaming.split_temporal_variables(variables, streaming.split_names(tm))
    assert _bridged_keys(head_vars) == _bridged_keys(shapes_of(tuple(sorted(kw.items())), "tips"))
    feed = YOLOv3T(num_classes=NC, channels=CH, feed="tips", **kw)
    feed.load_state_dict(flax_to_state_dict(head_vars), strict=True)
    fs = frames(3, seed=5)
    stream = StreamingDetector(tm)
    stream.reset(torch.from_numpy(fs[0]))
    for f in fs[1:]:
        stream.step(torch.from_numpy(f))
    with torch.no_grad():
        assert_head_close(feed.eval()(stream._buffers), tm(torch.from_numpy(np.stack(fs, axis=1))))


def test_rnn_refusals_beside_jax_failure():
    """The conv-RNN after an early correlation raises ValueError in the port;
    the JAX package fails on it (its GRU scans the correlation's 4-D routes
    and reads their rows as time); the other refusals mirror JAX's
    asserts."""
    x = jnp.zeros((1, 3, S, S, 3), jnp.float32)
    for kw in (dict(rnn_pos="late", k_join_pos="late"), dict(rnn_pos="out", k_join_type="max", k_join_pos="late")):
        kw = dict(kw, k=3, corr_pos="early", corr_d=2)
        jm = JaxYOLOv3T(num_classes=NC, channels=CH, **kw)
        with pytest.raises(ValueError, match="Incompatible shapes"):
            jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError, match="corr_pos='early'.*not built"):
            YOLOv3T(num_classes=NC, channels=CH, **kw)
        with pytest.raises(ValueError, match="not built"):
            build_model(YoloConfig(num_classes=NC, **kw))
    with pytest.raises(ValueError, match="k_join_pos='late'"):
        YOLOv3T(num_classes=NC, k=3, rnn_pos="late", k_join_pos="early")
    with pytest.raises(ValueError, match="k > 1"):
        YOLOv3T(num_classes=NC, k=1, rnn_pos="out")
    with pytest.raises(ValueError, match="rnn_pos"):
        YOLOv3T(num_classes=NC, k=3, rnn_pos="mid")
    with pytest.raises(ValueError, match="rnn_pos='out'"):
        YOLOv3T(num_classes=NC, k=3, rnn_pos="late", k_join_pos="late", feed="tips")
    # the int8 conv-RNN configurations serve in mixed precision (item 9a,
    # tests/test_torch_int8_temporal.py): the output GRUs stay real-valued
    with torch.device("meta"):
        mixed = YOLOv3T(num_classes=NC, k=3, rnn_pos="out", quant="static")
    keys = mixed.state_dict()
    assert any(k.endswith("qkernel") for k in keys)
    assert not any(k.endswith("qkernel") for k in keys if k.startswith("output"))


@pytest.mark.parametrize("argv", [
    ["--window", "3,1", "--k_join_pos", "late", "--rnn_pos", "late"],
    ["--window", "3,1", "--rnn_pos", "out", "--stream"],
], ids=["windows", "stream"])
def test_detect_twin_rnn_pos(argv):
    """The detect twin's synthetic mode with `--rnn_pos`, windowed and
    streamed: one request of two windows (or two frames of two streams) at
    64 px on the CPU, each with detections of the model the factory builds
    (the stream's split named in its line)."""
    preds = detect.main(["--device", "cpu", "--data_shape", str(S), "--batch_size", "2", "--num_requests", "2",
                         "--seed", "3"] + argv)
    assert len(preds) == 4
    assert detect.parse_args(argv).rnn_pos == argv[argv.index("--rnn_pos") + 1]
