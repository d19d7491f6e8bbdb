"""The port's data-parallel pieces in one process, on the CPU: the
per-process sharding against the JAX package's (parallel/multihost.py,
equal arrays), the one-process answers of the agreements, the process group
of the environment (parallel/mesh.py), and the global-batch BatchNorm
(models/layers.GlobalBatchNorm) in a group of one: float64 forward and
backward against autograd of the plain global-batch formula, close to the
native op's, while BatchNorm and the train step in a group of one stay bit
for bit what they are without a group.  Two processes:
tests/test_torch_ddp.py."""
import copy
import socket
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist

from videoyolo_tpu.parallel import multihost as jmultihost
from videoyolo_torch.models import layers
from videoyolo_torch.models.yolo3 import YOLOv3
from videoyolo_torch.parallel import mesh, multihost
from videoyolo_torch.train import lr, step
from torch_heap import return_heap  # noqa: F401  (autouse: the module's freed heap back to the system)

torch.set_num_threads(2)

EPS = layers.BN_EPS


@pytest.mark.parametrize("gb,pc", [(64, 1), (64, 4), (48, 3), (8, 8)])
def test_local_batch_size_matches_jax(gb, pc):
    assert multihost.local_batch_size(gb, pc) == jmultihost.local_batch_size(gb, pc) == gb // pc
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_size(gb + 1, 2 * pc if pc > 1 else 2)


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "keep"])
@pytest.mark.parametrize("n,epoch,seed,pc", [(24, 0, 233, 2), (24, 1, 233, 2), (101, 3, 0, 4), (7, 0, 5, 3),
                                             (1000, 17, 233, 8), (5, 2, 1, 1)])
def test_process_epoch_indices_match_jax(n, epoch, seed, pc, drop):
    """Each process's indices equal JAX's exactly; with drop_remainder the
    blocks are disjoint, contiguous in the permutation and cover n // pc * pc
    samples."""
    blocks = []
    for pid in range(pc):
        ours = multihost.process_epoch_indices(n, epoch, seed, pid, pc, drop_remainder=drop)
        ref = jmultihost.process_epoch_indices(n, epoch, seed, pid, pc, drop_remainder=drop)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
        blocks.append(ours)
    flat = np.concatenate(blocks)
    assert len(set(flat.tolist())) == len(flat) == (n // pc * pc if drop else n)


def test_one_process_answers_without_a_group():
    """No process group: rank 0 of 1, the coordinator, the agreements and
    the means the identity, BatchNorm on the native path."""
    assert not dist.is_initialized()
    assert multihost.process_index() == 0 and multihost.process_count() == 1 and multihost.is_coordinator()
    assert multihost.sync_flag(True) is True and multihost.sync_flag(0) is False
    assert multihost.sync_any(1) is True and multihost.sync_any(False) is False
    values = {"obj": torch.tensor(1.5), "total": torch.tensor(2.25)}
    assert multihost.global_mean(values) == values
    assert multihost.local_batch_size(64) == 64
    ours = multihost.process_epoch_indices(10, 1, seed=3)
    assert np.array_equal(ours, np.random.RandomState(4).permutation(10))


def test_mesh_environment_and_item13(monkeypatch):
    """`launched` reads torchrun's environment; the spatial mesh's names
    raise, naming item 13."""
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert not mesh.launched()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.launched()
    for fn in (mesh.make_2d_mesh, mesh.shard_batch, mesh.assert_spatial_safe):
        with pytest.raises(NotImplementedError, match="item 13"):
            fn(None)


@contextmanager
def _one_process_group(monkeypatch):
    """A gloo process group of one process from the environment, as
    torchrun would set it; torn down on the way out.  Its port is held
    for the group's life (tests/test_torch_ddp.py:held_port), so no other
    process is handed it before the store binds it."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        for key, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(port)).items():
            monkeypatch.setenv(key, value)
        with mesh.process_group("cpu", timeout_s=60) as device:
            assert device == torch.device("cpu") and dist.get_backend() == "gloo"
            yield device
    assert not dist.is_initialized()


@pytest.fixture
def group_of_one(monkeypatch):
    with _one_process_group(monkeypatch) as device:
        yield device


def test_group_of_one_answers(group_of_one):
    """In a group of one: the one-process answers (process_count is 1, so
    BatchNorm stays on the native op and the step averages no gradients)."""
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert multihost.is_coordinator() and multihost.process_count() == 1
    assert multihost.sync_flag(True) and not multihost.sync_any(False)
    values = {"obj": torch.tensor(1.5), "total": torch.tensor(2.25)}
    assert multihost.global_mean(values) == values


def _rows(shape, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g, dtype=dtype) * 1.7 + 0.4)


def _plain(x, weight, bias):
    """The global-batch formula, flax's: E[x^2] - E[x]^2 over every axis
    but the channels."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    mean = x.mean(dims)
    var = (x.square().mean(dims) - mean.square()).clamp_min(0)
    y = (x - mean.view(shape)) * torch.rsqrt(var + EPS).view(shape) * weight.view(shape) + bias.view(shape)
    return y, mean, var


@pytest.mark.parametrize("shape", [(3, 5, 4, 6), (2, 4, 3, 5, 5), (40, 6)], ids=["nchw", "ncthw", "rows"])
def test_global_batchnorm_float64_matches_autograd(group_of_one, shape):
    """GlobalBatchNorm in float64 (a group of one: the global batch is the
    local one): y, mean and var, and the gradients of x, weight and bias,
    against autograd of the plain formula; gradcheck passes."""
    c = shape[1]
    x = _rows(shape, 0).requires_grad_()
    w = _rows((c,), 1).requires_grad_()
    b = _rows((c,), 2).requires_grad_()
    dy = _rows(shape, 3)
    y, mean, var = layers.GlobalBatchNorm.apply(x, w, b, EPS)
    (y * dy).sum().backward()
    got = (x.grad.clone(), w.grad.clone(), b.grad.clone())
    for t in (x, w, b):
        t.grad = None
    ry, rmean, rvar = _plain(x, w, b)
    (ry * dy).sum().backward()
    for a, r in zip((y, mean, var) + got, (ry, rmean, rvar, x.grad, w.grad, b.grad)):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)
    small = tuple(t.detach().clone().requires_grad_() for t in (x[:2], w, b))
    assert torch.autograd.gradcheck(lambda *a: layers.GlobalBatchNorm.apply(*a, EPS)[0], small)


def test_global_batchnorm_close_to_the_native_op(group_of_one):
    """In float32 the Function and the native op normalise alike (the
    variance as E[x^2] - E[x]^2 against a mean of squared deviations), and
    give alike gradients."""
    x = _rows((4, 8, 5, 5), 4, torch.float32).requires_grad_()
    w, b = _rows((8,), 5, torch.float32), _rows((8,), 6, torch.float32)
    dy = _rows((4, 8, 5, 5), 7, torch.float32)
    y, mean, var = layers.GlobalBatchNorm.apply(x, w, b, EPS)
    dx = torch.autograd.grad(y, x, dy)[0]
    ny, nmean, ninvstd = torch.native_batch_norm(x, w, b, None, None, True, 0.0, EPS)
    ndx = torch.autograd.grad(ny, x, dy)[0]
    torch.testing.assert_close(y, ny, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mean, nmean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.rsqrt(var + EPS), ninvstd, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, ndx, rtol=1e-4, atol=1e-4)


def _bn_train(bn, x):
    x = x.clone().requires_grad_()
    y = bn(x)
    y.square().sum().backward()
    return y.detach(), x.grad, bn.weight.grad, bn.running_mean.clone(), bn.running_var.clone()


@pytest.mark.parametrize("phases", [1, 4])
def test_batchnorm_in_a_group_of_one_is_bit_equal(phases, monkeypatch):
    """A process group of one leaves BatchNorm on the native op: the output,
    the gradients and the running statistics bit for bit what they are
    without a group (the s2d stem's pooled phases too)."""
    bn = layers.BatchNorm(6, phases=phases).train()
    with torch.no_grad():
        bn.weight.copy_(_rows((6,), 8, torch.float32))
    x = _rows((2, 6 * phases, 5, 5), 9, torch.float32)
    plain = _bn_train(copy.deepcopy(bn), x)
    with _one_process_group(monkeypatch):
        grouped = _bn_train(copy.deepcopy(bn), x)
    for a, b in zip(plain, grouped):
        assert torch.equal(a, b)


def test_train_step_in_a_group_of_one_is_bit_equal(monkeypatch):
    """The full-width YOLOv3's train step (64 px, B=2, float32, two steps)
    in a group of one equals the step without a group bit for bit: losses,
    parameters and statistics."""
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rs.randn(2, 64, 64, 3).astype(np.float32)),
             "gt_boxes": torch.tensor([[[5.0, 6, 40, 50], [-1, -1, -1, -1]], [[0, 0, 63, 63], [-1, -1, -1, -1]]]),
             "gt_ids": torch.tensor([[[1.0], [-1]], [[2.0], [-1]]])}
    model = layers.init_weights(YOLOv3(num_classes=3), torch.Generator().manual_seed(0))

    def run(m):
        state = step.create_train_state(m, lr.lr_schedule("step", 1e-2, steps_per_epoch=10, epochs=2))
        fn = step.make_train_step(m, num_classes=3)
        return [fn(state, batch) for _ in range(2)], m.state_dict()

    plain = run(copy.deepcopy(model))
    with _one_process_group(monkeypatch):
        grouped = run(copy.deepcopy(model))
    for a, b in zip(grouped[0], plain[0]):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(grouped[1][k], plain[1][k]) for k in plain[1])


def test_average_gradients_in_a_group_of_one_is_bit_equal(monkeypatch):
    """`average_gradients` in a group of one (float32 and float64 gradients,
    one all-reduce each) leaves every gradient bit for bit as it was."""
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3).double())
    model[0](_rows((6, 5), 10, torch.float32)).sum().backward()
    model[1](_rows((6, 4), 11)).sum().backward()
    before = [p.grad.clone() for p in model.parameters()]
    with _one_process_group(monkeypatch):
        step.average_gradients(model)
    assert all(torch.equal(p.grad, b) for p, b in zip(model.parameters(), before))
