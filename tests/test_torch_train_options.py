"""The port's train step with its options against JAX's, on the full-width
YOLOv3 at 64 px in float64 (tests/test_torch_train_step.py says why float64
and gives the helpers): accumulation, frozen base, no decay on BN and
biases, label smoothing, mixup, color maps and a warmup.  A file of its
own, so that the JAX compiles of the two files run in parallel."""
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import PARAMS, STATS, _batch, _jax_run, _leaf_errors, _port_run, _variables
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    model, v = _variables()
    v0 = {k: t.double() for k, t in flax_to_state_dict(v).items()}
    return model, v, None, v0


def test_train_step_options_match_jax(setup):
    """accum_steps=2, freeze_base, no_wd_bn, label smoothing, mixup ratios,
    uint8 pixels with color maps, and a warmup whose first step has lr 0
    (the momentum still takes that step's gradient): two steps in float64,
    at B=4 (micro-batches of 2: one image a micro-batch would leave 4
    values a channel to the deepest BatchNorms)."""
    model, v, _, v0 = setup
    batch = _batch(options=True, b=4)
    opts = dict(
        lr=dict(mode="poly", base_lr=1e-2, steps_per_epoch=2, epochs=3, warmup_epochs=1),
        no_wd_bn=True, freeze_base=True,
        step=dict(accum_steps=2, label_smooth=True, mixup=True),
    )
    ref = _jax_run(model, v, batch, np.float64, 2, opts)
    ours = _port_run(v, batch, np.float64, 2, opts)
    for (o, om), (r, rm) in zip(ours, ref):
        for k in rm:
            np.testing.assert_allclose(om[k], rm[k], rtol=1e-6, err_msg=k)
    o, r = ours[-1][0], ref[-1][0]
    frozen = [k for k in PARAMS(r) if k.startswith("backbone.")]
    assert frozen and all(torch.equal(o[k], v0[k]) and torch.equal(r[k], v0[k]) for k in frozen)
    moved = [k for k in PARAMS(r) if k not in frozen]
    worst = max(_leaf_errors(o, r, v0, moved).items(), key=lambda kv: kv[1])
    assert worst[1] < 1e-5, worst
    for k in STATS(r):  # the frozen scopes' statistics update too
        torch.testing.assert_close(o[k], r[k], rtol=1e-5, atol=1e-7)
    assert not torch.equal(o["backbone.conv0.BatchNorm_0.running_mean"], v0["backbone.conv0.BatchNorm_0.running_mean"])
