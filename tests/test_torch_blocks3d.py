"""The 3D and 2+1D detection blocks (ROADMAP.md Queue 1 item 6) against the
JAX package on the CPU: the cells (`Conv21D`, `temporal_pad`,
`Conv1DTemporal`), YOLOv3T with '21' blocks (the late max join) and '3'
blocks (with the tip conv-RNN and the late mean join), YOLOv3Temporal with
conv 3 and 21 on its t_out paths (with and without the correlation
pyramid), their streams and splits, one float64 train step through the
2+1D blocks, the refusals beside the JAX package's batch mixing, and the
twins' `--block_conv_type`.

The models run at 64 px with narrow FPN channels (16, 8, 4) over the full
Darknet-53 from random flax variables carried across by the bridge;
detections within rtol=atol=1e-4 (tests/test_torch_rnn.py's helpers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rnn import (
    CH, NC, S, batch_mixes_in_jax, check_model_and_stream, check_splits, check_train_step_float64, fill_random,
    shapes_of,
)
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JaxYOLOv3T
from videoyolo_tpu.models.yolo3_temporal import YOLOv3Temporal as JaxYOLOv3Temporal
from videoyolo_torch import detect
from videoyolo_torch.models import layers
from videoyolo_torch.models.factory import YoloConfig, build_model
from videoyolo_torch.models.yolo3_temporal import YOLOv3T, YOLOv3Temporal
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

MODELS = {
    "block21-max": dict(k=3, k_join_type="max", k_join_pos="late", block_conv_type="21"),
    # the 3-D blocks with the tip conv-RNN and the mean join
    "block3-rnn-late-mean": dict(k=3, k_join_type="mean", k_join_pos="late", block_conv_type="3", rnn_pos="late"),
    "t5-conv3": dict(t=5, conv=3, t_out=True, corr_d=0),
    "t5-conv21": dict(t=5, conv=21, t_out=True, corr_d=0),
    "t5-conv3-pyramid": dict(t=5, conv=3, t_out=True, corr_d=2),
    "t5-conv21-pyramid": dict(t=5, conv=21, t_out=True, corr_d=2),
}
SPLITS = {"block21-max": "routes", "block3-rnn-late-mean": "routes", "t5-conv3": "routes",
          "t5-conv21": "routes", "t5-conv3-pyramid": "stage1", "t5-conv21-pyramid": "stage1"}


def _cell_check(jm, tm, x, train):
    """A cell's output (and in train mode its running statistics) against
    flax's on random variables."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    v = fill_random(shapes, 6)
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    tm.train(train)
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
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw", [dict(), dict(stride=2, mid=5, padding=1), dict(kernel=1, padding=0)],
                         ids=["k3", "stride2-mid", "k1"])
def test_conv21d_matches_flax(kw, train):
    """`Conv21D`: the (1, k, k) cell then the (k, 1, 1) cell, strides and
    padding on their axes, `mid` channels between."""
    x = np.random.RandomState(3).randn(2, 5, 9, 10, 6).astype(np.float32)
    tm = layers.Conv21D(6, 8, **kw)
    assert tm.ConvBNLeaky3D_0.Conv_0.kernel_size == (1,) + (kw.get("kernel", 3),) * 2
    _cell_check(jlayers.Conv21D(8, **kw), tm, x, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw", [dict(kernel=3, padding=1), dict(kernel=3, padding=0, stride=2)], ids=["same", "s2"])
def test_conv1d_temporal_matches_flax(kw, train):
    """`Conv1DTemporal`: the depthwise (k, 1, 1) conv over time, BN, leaky;
    its kernel starts at zero (flax's init, and `init_weights`)."""
    x = np.random.RandomState(4).randn(2, 5, 4, 3, 6).astype(np.float32)
    tm = layers.Conv1DTemporal(6, **kw)
    assert tm.Conv_0.weight.shape == (6, 1, kw["kernel"], 1, 1)
    layers.init_weights(tm, torch.Generator().manual_seed(0))
    assert not tm.Conv_0.weight.any()
    _cell_check(jlayers.Conv1DTemporal(6, **kw), tm, x, train)


@pytest.mark.parametrize("zeros", [True, False], ids=["zeros", "edge"])
@pytest.mark.parametrize("padding", [1, 2])
def test_temporal_pad_matches_jax(padding, zeros):
    x = np.random.RandomState(5).randn(2, 3, 4, 5, 6).astype(np.float32)
    got = layers.temporal_pad(torch.from_numpy(x), padding, zeros)
    want = np.asarray(jlayers.temporal_pad(jnp.asarray(x), padding, zeros))
    assert got.shape == want.shape == (2, 3 + 2 * padding, 4, 5, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_3d_blocks_and_stream_match_jax(name):
    """YOLOv3T with '3' / '21' blocks and YOLOv3Temporal with conv 3 / 21
    against JAX's apply and postprocess: the windowed forward, and the
    stream (the route split; the pyramid's stage-1 split) at every step."""
    check_model_and_stream(MODELS[name], SPLITS[name], seed=11)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_3d_splits_match_jax(name):
    check_splits(MODELS[name])


def test_3d_names_and_factory():
    """The flax names: a '3' block's cells are `ConvBNLeaky3D_0`, a '21'
    block's 3x3 cells `Conv21D_0` and its 1x1 cells (1, 1, 1) 3-D cells;
    the factory builds both families with JAX's parameters."""
    with torch.device("meta"):
        b21 = build_model(YoloConfig(num_classes=NC, k=3, k_join_pos="late", block_conv_type="21"))
        t3 = build_model(YoloConfig(num_classes=NC, t_out=True, block_conv_type="3"))
    assert b21.block0._TCell_0.ConvBNLeaky3D_0.Conv_0.weight.shape == (512, 1024, 1, 1, 1)
    assert b21.block0._TCell_1.Conv21D_0.ConvBNLeaky3D_0.Conv_0.weight.shape == (1024, 512, 1, 3, 3)
    assert b21.block0._TCell_1.Conv21D_0.ConvBNLeaky3D_1.Conv_0.weight.shape == (1024, 1024, 3, 1, 1)
    assert t3.block2._TCell_5.ConvBNLeaky3D_0.Conv_0.weight.shape == (256, 128, 3, 3, 3)
    for model, kw in ((b21, dict(k=3, k_join_type="max", k_join_pos="late", block_conv_type="21")),
                      (t3, dict(t=5, conv=3, t_out=True, corr_d=0))):
        jm = (JaxYOLOv3Temporal if "t" in kw else JaxYOLOv3T)(num_classes=NC, **kw)
        shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
                                jnp.zeros((1, kw.get("k") or 5, S, S, 3), jnp.float32))
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        want = {k: tuple(v.shape) for k, v in flax_to_state_dict(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
        assert got == want


def test_block21_train_step_float64_matches_jax():
    """One float64 step of YOLOv3T with 2+1D blocks (the late max join)
    against JAX's step: losses, every update, the 3-D cells' statistics
    over the window."""
    ours, v0 = check_train_step_float64(MODELS["block21-max"], seed=12)
    key = "block1._TCell_3.Conv21D_0.ConvBNLeaky3D_1.Conv_0.weight"
    assert float((ours[key] - v0[key]).abs().max()) > 0


def test_3d_refusals_beside_jax_batch_mixing():
    """3-D blocks on 4-D routes (after an early correlation, and the 3-D
    funnel) raise ValueError in the port; the JAX package builds them, and
    its scores of an image move with the other image of its batch.  The
    other refusals mirror JAX's asserts."""
    x = np.random.RandomState(13).rand(2, 3, S, S, 3).astype(np.float32)
    kw = dict(k=3, k_join_type="max", k_join_pos="late", block_conv_type="21", corr_pos="early", corr_d=2)
    jm = JaxYOLOv3T(num_classes=NC, channels=CH, **kw)
    v = fill_random(shapes_of(tuple(sorted(kw.items()))), 13)
    assert batch_mixes_in_jax(jm, v, x) > 1e-3
    with pytest.raises(ValueError, match="not built"):
        YOLOv3T(num_classes=NC, channels=CH, **kw)
    x5 = np.random.RandomState(14).rand(2, 5, S, S, 3).astype(np.float32)
    kw5 = dict(t=5, conv=3, t_out=False, corr_d=0)
    jm = JaxYOLOv3Temporal(num_classes=NC, channels=CH, **kw5)
    v = fill_random(shapes_of(tuple(sorted(kw5.items()))), 14)
    assert batch_mixes_in_jax(jm, v, x5) > 1e-3
    for conv in (3, 21):
        with pytest.raises(ValueError, match="not built"):
            YOLOv3Temporal(num_classes=NC, conv=conv, t_out=False)
        with pytest.raises(ValueError, match="not built"):
            build_model(YoloConfig(num_classes=NC, temporal=True, block_conv_type=str(conv)))
        with pytest.raises(ValueError, match="not built"):
            YOLOv3Temporal(num_classes=NC, t=1, conv=conv, t_out=True)
    with pytest.raises(ValueError, match="k > 1"):
        YOLOv3T(num_classes=NC, k=1, block_conv_type="3")
    with pytest.raises(ValueError, match="join late"):
        YOLOv3T(num_classes=NC, k=3, k_join_pos="early", k_join_type="max", block_conv_type="3")
    with pytest.raises(ValueError, match="join late"):
        YOLOv3T(num_classes=NC, k=3, k_join_pos="late", block_conv_type="21")
    with pytest.raises(ValueError, match="block_conv_type"):
        YOLOv3T(num_classes=NC, k=3, k_join_pos="late", k_join_type="max", block_conv_type="4")
    with pytest.raises(ValueError, match="2, 3 or 21"):
        YOLOv3Temporal(num_classes=NC, conv=4)
    with pytest.raises(ValueError, match="frame-pure"):
        YOLOv3T(num_classes=NC, k=3, k_join_pos="late", k_join_type="max", block_conv_type="3", feed="tips")
    # the int8 2+1D cell (item 9a, tests/test_torch_int8_temporal.py): two
    # int8 halves, each with its own scale; the fused pipeline is 2-D only
    cell = layers.Conv21D(4, 8, quant="static")
    assert cell.ConvBNLeaky3D_0.qkernel.shape == (8, 4, 1, 3, 3) and cell.ConvBNLeaky3D_1.qkernel.shape == (8, 8, 3, 1, 1)
    assert {k for k in cell.state_dict() if k.endswith("xscale")} == {"ConvBNLeaky3D_0.xscale", "ConvBNLeaky3D_1.xscale"}
    with pytest.raises(ValueError, match="3-D int8 cells"):
        layers.Conv21D(4, 8, quant="fused")


@pytest.mark.parametrize("argv", [
    ["--window", "3,1", "--k_join_type", "mean", "--k_join_pos", "late", "--block_conv_type", "3"],
    ["--window", "3,1", "--k_join_pos", "late", "--block_conv_type", "21", "--stream"],
    ["--window", "5,1", "--temp", "--mult_out", "--block_conv_type", "21"],
], ids=["windows", "stream", "t5"])
def test_detect_twin_block_conv_type(argv):
    """The detect twin's synthetic mode with `--block_conv_type` on YOLOv3T
    windows, its stream, and YOLOv3Temporal's per-frame heads, at 64 px on
    the CPU."""
    preds = detect.main(["--device", "cpu", "--data_shape", str(S), "--batch_size", "1", "--num_requests", "2",
                         "--seed", "4"] + argv)
    assert len(preds) == (10 if "--mult_out" in argv else 2)
