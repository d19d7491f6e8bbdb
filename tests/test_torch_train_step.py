"""The port's train step against `jax.jit(make_train_step(...))` on the
full-width YOLOv3 (Darknet-53 and the FPN head at their published widths),
at 64 px, B=2, from the same bridged weights, on the CPU.

Tolerances.  At 64 px the deepest maps are 2x2, so BatchNorm in train mode
normalises 8 values a channel, and the gradient through it amplifies
rounding: even at lr 1e-6 one step moves the loss by 1%.  JAX's own
float32 step is 0.2-1.2% (relative L2 of the update) from its float64 step
after one step and 2.5% after three, and the port's float32 step 1.4% and
5.4% (its CPU convs round differently).  So the port is held to JAX twice:
  * in float64, where rounding is out of the way, tightly: losses rtol
    1e-6, each updated leaf within 1e-5 of its largest update magnitude,
    batch_stats rtol 1e-5 (measured: 3e-8 after three steps in L2; the
    decode casts the heads to float32 on both sides);
  * in float32, as far as float32 allows: the first step's losses (the
    same parameters on both sides) rtol 1e-4, the later steps' total loss
    rtol 0.1 (a single component swings by up to 10%);
    the update and the batch_stats within a relative L2 of 0.05 of JAX's
    float32 result after one step and 0.15 after three.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoyolo_tpu.models.yolo3 import YOLOv3 as JYOLOv3
from videoyolo_tpu.train import lr as jlr
from videoyolo_tpu.train import step as jstep
from videoyolo_torch.models.yolo3 import YOLOv3
from videoyolo_torch.train import lr, step
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict

torch.set_num_threads(2)

S, B, C, M = 64, 2, 4, 6
STEPS = 3
LR = dict(mode="step", base_lr=1e-2, steps_per_epoch=10, epochs=3)


def _variables():
    model = JYOLOv3(num_classes=C)
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.PRNGKey(0), np.zeros((1, S, S, 3), np.float32))
    rs = np.random.RandomState(1)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    return model, jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def _batch(options: bool, b: int = B):
    rs = np.random.RandomState(2)
    gtb = np.full((b, M, 4), -1, np.float32)
    gti = np.full((b, M, 1), -1, np.float32)
    gtb[0, :2] = [[5, 6, 40, 50], [20, 2, 60, 30]]
    gti[0, :2, 0] = [1, 3]
    gtb[1:, 0], gti[1:, 0, 0] = [0, 0, 63, 63], 2
    batch = {"gt_boxes": gtb, "gt_ids": gti}
    if options:  # uint8 pixels with per-image color maps, and mixup ratios
        batch["image"] = rs.randint(0, 256, (b, S, S, 3)).astype(np.uint8)
        batch["color"] = np.concatenate([np.eye(3) / 60.0 + rs.randn(b, 3, 3) * 1e-3, rs.randn(b, 3, 1)], -1).astype(np.float32)
        batch["gt_mix"] = rs.uniform(0.3, 1.0, (b, M, 1)).astype(np.float32)
    else:
        batch["image"] = rs.randn(b, S, S, 3).astype(np.float32)
    return batch


def _float(batch, dtype):
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v for k, v in batch.items()}


def _jax_run(model, v, batch, dtype, steps, opts):
    """JAX's state after each step: (torch-keyed state, metrics)."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)
        lr_fn = jlr.lr_schedule(**opts.get("lr", LR))
        tx = jstep.make_optimizer(lr_fn, no_wd_bn=opts.get("no_wd_bn", False),
                                  freeze_base=opts.get("freeze_base", False))
        state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                                 batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
        fn = jax.jit(jstep.make_train_step(model, num_classes=C, **opts.get("step", {})))
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


def _port_run(v, batch, dtype, steps, opts):
    tdtype = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    model = YOLOv3(num_classes=C, dtype=tdtype).to(tdtype)
    model.load_state_dict({k: t.to(tdtype) if t.is_floating_point() else t for k, t in flax_to_state_dict(v).items()})
    state = step.create_train_state(model, lr.lr_schedule(**opts.get("lr", LR)),
                                    no_wd_bn=opts.get("no_wd_bn", False), freeze_base=opts.get("freeze_base", False))
    fn = step.make_train_step(model, num_classes=C, **opts.get("step", {}))
    tb = {k: torch.from_numpy(a) for k, a in _float(batch, dtype).items()}
    out = []
    for _ in range(steps):
        metrics = fn(state, tb)
        out.append(({k: t.detach().double().clone() for k, t in model.state_dict().items()},
                    {k: float(m) for k, m in metrics.items()}))
    return out


@pytest.fixture(scope="module")
def setup():
    model, v = _variables()
    batch = _batch(options=False)
    v0 = {k: t.double() for k, t in flax_to_state_dict(v).items()}
    return model, v, batch, v0


@pytest.fixture(scope="module")
def jax_runs(setup):
    model, v, batch, _ = setup
    return {dt: _jax_run(model, v, batch, dt, STEPS, {}) for dt in (np.float32, np.float64)}


PARAMS = lambda state: [k for k in state if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]  # noqa: E731
STATS = lambda state: [k for k in state if k.endswith(("running_mean", "running_var"))]  # noqa: E731


def _leaf_errors(ours, ref, v0, keys):
    """max |d_ours - d_ref| / max |d_ref| of each leaf, d = after - before."""
    out = {}
    for k in keys:
        d_ref = ref[k] - v0[k]
        scale = float(d_ref.abs().max())
        out[k] = float(((ours[k] - v0[k]) - d_ref).abs().max()) / max(scale, 1e-30)
    return out


def _rel_l2(a, b, v0, keys):
    num = sum(float(((a[k] - v0[k]) - (b[k] - v0[k])).pow(2).sum()) for k in keys)
    den = sum(float((b[k] - v0[k]).pow(2).sum()) for k in keys)
    return (num / den) ** 0.5


@pytest.mark.parametrize("n", [1, STEPS])
def test_train_step_float64_matches_jax(setup, jax_runs, n):
    _, v, batch, v0 = setup
    ours = _port_run(v, batch, np.float64, n, {})
    ref = jax_runs[np.float64]
    for (o, om), (r, rm) in zip(ours, ref):
        for k in rm:
            np.testing.assert_allclose(om[k], rm[k], rtol=1e-6, err_msg=k)
    o, r = ours[-1][0], ref[n - 1][0]
    worst = max(_leaf_errors(o, r, v0, PARAMS(r)).items(), key=lambda kv: kv[1])
    assert worst[1] < 1e-5, worst
    for k in STATS(r):
        torch.testing.assert_close(o[k], r[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [1, STEPS])
def test_train_step_float32_matches_jax(setup, jax_runs, n):
    _, v, batch, v0 = setup
    ours = _port_run(v, batch, np.float32, n, {})
    j32 = jax_runs[np.float32]
    for i, ((o, om), (r, rm)) in enumerate(zip(ours, j32)):
        assert set(om) == set(rm) == {"obj", "center", "scale", "cls", "total"}
        for k in (rm if i == 0 else ["total"]):  # later, single components swing by 10%
            np.testing.assert_allclose(om[k], rm[k], rtol=1e-4 if i == 0 else 0.1, err_msg=f"step {i} {k}")
    o, r = ours[-1][0], j32[n - 1][0]
    for keys in (PARAMS(r), STATS(r)):
        err = _rel_l2(o, r, v0, keys)
        assert err <= (0.05 if n == 1 else 0.15), err
