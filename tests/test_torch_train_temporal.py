"""The port's train step on YOLOv3T windows against
`jax.jit(make_train_step(...))`: the full-width model (Darknet-53 per frame,
k=3, the late max join, the early correlation at d=2, whose cost volumes the
gradient crosses) at 64 px, B=2 windows of uint8 frames with one colour map
a window, from the same bridged weights, on the CPU.

Tolerances, as tests/test_torch_train_step.py holds the 2D model and for
the same reason (at 64 px BatchNorm in train mode normalises 12 values a
channel at the deepest level, the B*k frames, and amplifies rounding):
  * float64, tight: losses rtol 1e-6, each updated leaf within 1e-5 of its
    largest update, batch_stats rtol 1e-5 with atol 1e-6 (the heads'
    float32 decode leaves 1e-7-relative differences in the update, which a
    near-zero statistic carries after three steps: measured 2.3e-7 on one
    of 512).  Both packages compute the cost
    volumes in float32 whatever the model's dtype, in different summation
    orders; that rounding alone moves the float64 step 3e-6 in the loss and
    4e-5 in the update after one step and, amplified, 0.4% in the update
    after three.  So the float64 runs take the cost volumes in float64 on
    both sides: the JAX Corr's cast through a `jnp` whose float32 is
    float64 (monkeypatched in its module for the run), the port's through
    `layers.CORR_DTYPE`;
  * float32, loose, the models as they are: the first step's losses rtol
    1e-4, later totals rtol 0.1; the update and the batch_stats within a
    relative L2 of 0.05 of JAX's float32 result after one step and 0.15
    after three.
The batch_stats are the running statistics after the steps: flax's biased
variance over the B*k frames folded into the batch.  A checkpoint of the
trained port model is read by the JAX package, and a JAX one by the port.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.models.yolo3_temporal import YOLOv3T as JYOLOv3T
from videoyolo_tpu.train import checkpoint as jckpt
from videoyolo_tpu.train import lr as jlr
from videoyolo_tpu.train import step as jstep
from videoyolo_torch.models import layers
from videoyolo_torch.models.yolo3_temporal import YOLOv3T
from videoyolo_torch.train import checkpoint, lr, step
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict

torch.set_num_threads(2)

S, B, K, C, M = 64, 1, 3, 4, 6
STEPS = 3
LR = dict(mode="step", base_lr=1e-2, steps_per_epoch=10, epochs=3)
CFG = dict(num_classes=C, k=K, k_join_type="max", k_join_pos="late", corr_pos="early", corr_d=2)


def _variables():
    model = JYOLOv3T(**CFG)
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.PRNGKey(0),
                            np.zeros((1, K, S, S, 3), np.float32))
    rs = np.random.RandomState(1)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    return model, jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def _batch():
    """B uint8 windows of K frames (neighbouring frames of one clip), one
    colour map a window, the key frame's boxes.  The colour map's entries
    are powers of two, so it rounds nowhere and both packages see the same
    pixels (apply_color itself is held to JAX's in tests/test_torch_train.py)."""
    rs = np.random.RandomState(2)
    clip = rs.randint(0, 256, (B + K - 1, S, S, 3)).astype(np.uint8)
    gtb = np.full((B, M, 4), -1, np.float32)
    gti = np.full((B, M, 1), -1, np.float32)
    gtb[0, :2] = [[5, 6, 40, 50], [20, 2, 60, 30]]
    gti[0, :2, 0] = [1, 3]
    color = np.concatenate([np.eye(3) * 2.0**-6 + np.roll(np.eye(3), 1, 1) * 2.0**-10, np.full((3, 1), -2.0)], -1)
    return {"image": np.stack([clip[i:i + K] for i in range(B)]),
            "color": np.broadcast_to(color, (B, 3, 4)).astype(np.float32), "gt_boxes": gtb, "gt_ids": gti}


def _float(batch, dtype):
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v for k, v in batch.items()}


def _jax_run(model, v, batch, dtype, steps):
    """JAX's state after each step: (torch-keyed state, metrics)."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)
        tx = jstep.make_optimizer(jlr.lr_schedule(**LR))
        state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                 batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
        fn = jax.jit(jstep.make_train_step(model, num_classes=C))
        jb = {k: jnp.asarray(a) for k, a in _float(batch, dtype).items()}
        out = []
        for _ in range(steps):
            state, metrics = fn(state, jb)
            variables = {"params": state.params, "batch_stats": state.batch_stats}
            out.append((
                {k: t.double() for k, t in flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables)).items()},
                {k: float(m) for k, m in metrics.items()},
            ))
        return out


def _port_model(v, tdtype):
    model = YOLOv3T(**CFG, dtype=tdtype).to(tdtype)
    model.load_state_dict({k: t.to(tdtype) if t.is_floating_point() else t for k, t in flax_to_state_dict(v).items()})
    return model


def _port_run(v, batch, dtype, steps):
    tdtype = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    model = _port_model(v, tdtype)
    state = step.create_train_state(model, lr.lr_schedule(**LR))
    fn = step.make_train_step(model, num_classes=C)
    tb = {k: torch.from_numpy(a) for k, a in _float(batch, dtype).items()}
    out = []
    for _ in range(steps):
        metrics = fn(state, tb)
        out.append(({k: t.detach().double().clone() for k, t in model.state_dict().items()},
                    {k: float(m) for k, m in metrics.items()}))
    return out, model


@pytest.fixture(scope="module")
def setup():
    model, v = _variables()
    v0 = {k: t.double() for k, t in flax_to_state_dict(v).items()}
    return model, v, _batch(), v0


class _Float64Jnp:
    """`jax.numpy` with float32 read as float64: the JAX Corr's cast."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def runs(setup):
    """Each package's runs in float32 and in float64 (with float64 cost
    volumes): {dtype: (jax run, (port run, port model))}."""
    model, v, batch, _ = setup
    out = {np.float32: (_jax_run(model, v, batch, np.float32, STEPS), _port_run(v, batch, np.float32, STEPS))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "jnp", _Float64Jnp())
        mp.setattr(layers, "CORR_DTYPE", torch.float64)
        out[np.float64] = (_jax_run(model, v, batch, np.float64, STEPS), _port_run(v, batch, np.float64, STEPS))
    return out


@pytest.fixture(scope="module")
def jax_runs(runs):
    return {dt: r[0] for dt, r in runs.items()}


@pytest.fixture(scope="module")
def port_runs(runs):
    return {dt: r[1] for dt, r in runs.items()}


PARAMS = lambda state: [k for k in state if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]  # noqa: E731
STATS = lambda state: [k for k in state if k.endswith(("running_mean", "running_var"))]  # noqa: E731


def _leaf_errors(ours, ref, v0, keys):
    """max |d_ours - d_ref| / max |d_ref| of each leaf, d = after - before."""
    out = {}
    for k in keys:
        d_ref = ref[k] - v0[k]
        out[k] = float(((ours[k] - v0[k]) - d_ref).abs().max()) / max(float(d_ref.abs().max()), 1e-30)
    return out


def _rel_l2(a, b, v0, keys):
    num = sum(float(((a[k] - v0[k]) - (b[k] - v0[k])).pow(2).sum()) for k in keys)
    den = sum(float((b[k] - v0[k]).pow(2).sum()) for k in keys)
    return (num / den) ** 0.5


@pytest.mark.parametrize("n", [1, STEPS])
def test_window_train_step_float64_matches_jax(setup, jax_runs, port_runs, n):
    _, _, _, v0 = setup
    ours, ref = port_runs[np.float64][0][:n], jax_runs[np.float64][:n]
    for (o, om), (r, rm) in zip(ours, ref):
        for k in rm:
            np.testing.assert_allclose(om[k], rm[k], rtol=1e-6, err_msg=k)
    o, r = ours[-1][0], ref[-1][0]
    worst = max(_leaf_errors(o, r, v0, PARAMS(r)).items(), key=lambda kv: kv[1])
    assert worst[1] < 1e-5, worst
    # the stage-1 stem learns through the cost volumes too
    stem = "stage1.conv0.Conv_0.weight"
    assert float((o[stem] - v0[stem]).abs().max()) > 0
    for k in STATS(r):
        torch.testing.assert_close(o[k], r[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, STEPS])
def test_window_train_step_float32_matches_jax(setup, jax_runs, port_runs, n):
    _, _, _, v0 = setup
    ours, j32 = port_runs[np.float32][0][:n], jax_runs[np.float32][:n]
    for i, ((o, om), (r, rm)) in enumerate(zip(ours, j32)):
        assert set(om) == set(rm) == {"obj", "center", "scale", "cls", "total"}
        for k in (rm if i == 0 else ["total"]):  # later, single components swing by 10%
            np.testing.assert_allclose(om[k], rm[k], rtol=1e-4 if i == 0 else 0.1, err_msg=f"step {i} {k}")
    o, r = ours[-1][0], j32[-1][0]
    for keys in (PARAMS(r), STATS(r)):
        err = _rel_l2(o, r, v0, keys)
        assert err <= (0.05 if n == 1 else 0.15), err


def test_window_bn_statistics_over_folded_frames(setup, jax_runs, port_runs):
    """After one float64 step every running mean and variance equals
    flax's: the biased statistics of the B*k frames of each window batch
    (the stage-1 stem, a per-frame cell), blended 0.9 / 0.1."""
    _, v, batch, v0 = setup
    ours, ref = port_runs[np.float64][0][0][0], jax_runs[np.float64][0][0]
    stem = "stage1.conv0.BatchNorm_0"
    # the stem's batch statistics by hand: normalised frames -> conv -> biased moments over B*k frames
    model = _port_model(v, torch.float64)
    from videoyolo_torch.ops.color import apply_color

    x = apply_color(torch.from_numpy(batch["image"]), torch.from_numpy(batch["color"]).double()).double()
    conv = model.stage1.conv0.Conv_0
    y = conv(x.flatten(0, 1).permute(0, 3, 1, 2))
    assert y.shape[0] == B * K
    mean, var = y.mean(dim=(0, 2, 3)), y.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours[f"{stem}.running_mean"], 0.9 * v0[f"{stem}.running_mean"] + 0.1 * mean)
    torch.testing.assert_close(ours[f"{stem}.running_var"], 0.9 * v0[f"{stem}.running_var"] + 0.1 * var)
    for k in STATS(ref):
        torch.testing.assert_close(ours[k], ref[k], rtol=1e-5, atol=1e-6)


def test_window_checkpoints_both_ways(setup, port_runs, tmp_path):
    """The port's trained YOLOv3T written by `save_params` is read by the
    JAX package's `load_variables` against its own template, leaf for leaf;
    a JAX-written file of the same tree loads into the port bit for bit.
    (Each file holds the full-width model: removed at the end.)"""
    _, v, _, _ = setup
    trained = checkpoint.variables_of(port_runs[np.float32][1])
    checkpoint.save_params(str(tmp_path / "yolo3t"), trained, 0.0, 0.0, epoch=1, save_interval=1)
    path = str(tmp_path / "yolo3t_0001.params")
    template = jax.tree_util.tree_map(np.zeros_like, v)
    read = jax.tree_util.tree_map(np.asarray, jckpt.load_variables(path, template))
    os.remove(path)
    for (pa, a), (pb, b) in zip(sorted(jax.tree_util.tree_leaves_with_path(read), key=lambda t: str(t[0])),
                                sorted(jax.tree_util.tree_leaves_with_path(trained), key=lambda t: str(t[0]))):
        assert str(pa) == str(pb) and np.array_equal(a, np.asarray(b)), str(pa)
    jpath = str(tmp_path / "jax.params")
    jckpt.save_variables(jpath, v)
    fresh = checkpoint.load_into(YOLOv3T(**CFG), checkpoint.load_variables(jpath))
    os.remove(jpath)
    for k, t in flax_to_state_dict(v).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], t), k
