"""K2's gradient on the CPU: the plain adjoint of the cost volume
(`correlation_kernel.cost_volume_backward_plain`) against `jax.vjp` of the
JAX package's XLA form and against torch autograd of `correlation_plain`;
the autograd Function `CostVolume` on its CPU route; the Corr layer's and a
per-frame cell's gradients in train mode against JAX's; and what the JAX
package does when asked for the gradient of its Pallas kernel.

The adjoint kernel itself is CUDA and runs only on the card
(chip_smoke.py holds it against the plain adjoint there); here its entry
point must refuse a CPU tensor.  Tolerance: 1e-6 (absolute and relative)
in float32, the same products summed over the displacements in another
order than XLA's transposed program (measured up to 7.2e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_temporal import random_variables
from videoyolo_tpu.models import layers as jlayers
from videoyolo_tpu.ops.correlation import correlation as jax_correlation
from videoyolo_tpu.ops.pallas_correlation import correlation_pallas
from videoyolo_torch.models import layers
from videoyolo_torch.ops.correlation import (
    CostVolume, CostVolumePair, correlation, correlation_plain, num_corr_channels,
)
from videoyolo_torch.ops.correlation_kernel import cost_volume_backward, cost_volume_backward_plain
from videoyolo_torch.utils.flax_bridge import flax_to_state_dict

torch.set_num_threads(2)

GRAD_TOL = dict(rtol=1e-6, atol=1e-6)
# (B, H, W, C, d, stride2): d = 1, 2, 4, odd H and W, B = 1 and 3, a stride2 of 2
CASES = [(1, 5, 7, 3, 1, 1), (3, 7, 5, 8, 2, 1), (3, 9, 11, 16, 4, 1), (1, 13, 13, 32, 4, 1),
         (3, 7, 9, 4, 4, 2), (1, 5, 5, 3, 0, 1)]
IDS = [f"B{b}_{h}x{w}x{c}_d{d}_s{s}" for b, h, w, c, d, s in CASES]


def _inputs(seed, b, h, w, c, d, s2):
    """A (B, 3, H, W, C) window (the frames are taken as slices of it, as
    Corr takes them) and a cotangent of the cost volume."""
    rs = np.random.RandomState(seed)
    win = rs.randn(b, 3, h, w, c).astype(np.float32)
    g = rs.randn(b, h, w, num_corr_channels(d, s2)).astype(np.float32)
    return win, g


@pytest.mark.parametrize("b,h,w,c,d,s2", CASES, ids=IDS)
def test_plain_adjoint_matches_jax_vjp_and_autograd(b, h, w, c, d, s2):
    """gf1 and gf2 of frames 0 and 1 of a window (strided slices) against
    jax.vjp of the XLA form and torch autograd of correlation_plain."""
    win, g = _inputs(b * 100 + h * 10 + d, b, h, w, c, d, s2)
    _, vjp = jax.vjp(lambda a, z: jax_correlation(a, z, d, 1, 1, s2), jnp.asarray(win[:, 0]), jnp.asarray(win[:, 1]))
    j1, j2 = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    t = torch.from_numpy(win)
    f1, f2 = t[:, 0], t[:, 1]
    assert f1.stride(0) == 3 * h * w * c and f1.data_ptr() != f2.data_ptr()  # the window's batch stride
    p1, p2 = cost_volume_backward_plain(torch.from_numpy(g), f1, f2, d, s2)
    assert p1.shape == p2.shape == (b, h, w, c) and p1.is_contiguous() and p2.is_contiguous()
    np.testing.assert_allclose(p1.numpy(), j1, **GRAD_TOL)
    np.testing.assert_allclose(p2.numpy(), j2, **GRAD_TOL)
    leaf = t.clone().requires_grad_()
    correlation_plain(leaf[:, 0], leaf[:, 1], d, 1, 1, s2).backward(torch.from_numpy(g))
    torch.testing.assert_close(p1, leaf.grad[:, 0], **GRAD_TOL)
    torch.testing.assert_close(p2, leaf.grad[:, 1], **GRAD_TOL)
    assert float(leaf.grad[:, 2].abs().max()) == 0


def test_cost_volume_function_cpu_route():
    """CostVolume on CPU tensors: its forward is correlation_plain and its
    backward the plain adjoint, through window slices, a non-contiguous
    cotangent and twice-used frames; gradcheck in float64."""
    win, g = _inputs(7, 2, 7, 9, 6, 2, 1)
    x = torch.from_numpy(win).requires_grad_()
    out = CostVolume.apply(x[:, 0], x[:, 1], 2, 1) + 2 * CostVolume.apply(x[:, 2], x[:, 1], 2, 1)
    torch.testing.assert_close(out, correlation_plain(x[:, 0], x[:, 1], 2, 1, 1, 1)
                               + 2 * correlation_plain(x[:, 2], x[:, 1], 2, 1, 1, 1), rtol=0, atol=0)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # strided, same values
    assert not gt.is_contiguous()
    out.backward(gt)
    ref = x.detach().clone().requires_grad_()
    (correlation_plain(ref[:, 0], ref[:, 1], 2, 1, 1, 1) + 2 * correlation_plain(ref[:, 2], ref[:, 1], 2, 1, 1, 1)
     ).backward(torch.from_numpy(g))
    torch.testing.assert_close(x.grad, ref.grad, **GRAD_TOL)
    small = torch.randn(1, 3, 4, 5, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(3),
                        requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: CostVolume.apply(v[:, 0], v[:, 2], 1, 1), (small,))
    with torch.inference_mode():  # the serving path: no graph, the same values
        torch.testing.assert_close(CostVolume.apply(x[:, 0], x[:, 1], 2, 1),
                                   correlation_plain(x[:, 0], x[:, 1], 2, 1, 1, 1), rtol=0, atol=0)
    # on the CPU `correlation` keeps to the plain version, which autograd differentiates
    assert correlation(x[:, 0], x[:, 1], 2, 1, 1, 1).grad_fn.name() != "CostVolumeBackward"


def test_cost_volume_pair_cpu_route():
    """CostVolumePair on a CPU window: its two volumes are correlation_plain
    of frames 0 and 2 against frame 1, and its backward (the plain pair
    adjoint) gives the window's gradient of autograd through two
    correlation_plains, frame 1's the sum of both volumes'; a volume
    without a gradient counts as zero; gradcheck in float64."""
    win, g = _inputs(8, 2, 7, 9, 6, 2, 1)
    gb = np.random.RandomState(9).randn(*g.shape).astype(np.float32)
    x = torch.from_numpy(win).requires_grad_()
    ca, cb = CostVolumePair.apply(x, 2, 1)
    torch.testing.assert_close(ca, correlation_plain(x[:, 0], x[:, 1], 2, 1, 1, 1), rtol=0, atol=0)
    torch.testing.assert_close(cb, correlation_plain(x[:, 2], x[:, 1], 2, 1, 1, 1), rtol=0, atol=0)
    torch.autograd.backward((ca, cb), (torch.from_numpy(g), torch.from_numpy(gb)))
    ref = x.detach().clone().requires_grad_()
    torch.autograd.backward((correlation_plain(ref[:, 0], ref[:, 1], 2, 1, 1, 1),
                             correlation_plain(ref[:, 2], ref[:, 1], 2, 1, 1, 1)),
                            (torch.from_numpy(g), torch.from_numpy(gb)))
    torch.testing.assert_close(x.grad, ref.grad, **GRAD_TOL)
    x.grad = None
    CostVolumePair.apply(x, 2, 1)[0].backward(torch.from_numpy(g))
    ref.grad = None
    correlation_plain(ref[:, 0], ref[:, 1], 2, 1, 1, 1).backward(torch.from_numpy(g))
    torch.testing.assert_close(x.grad, ref.grad, **GRAD_TOL)
    small = torch.randn(1, 3, 4, 5, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(4),
                        requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: CostVolumePair.apply(v, 1, 1), (small,))


def test_adjoint_kernel_entry_raises_on_cpu_tensor():
    f = torch.zeros(2, 5, 6, 4)
    g = torch.zeros(2, 5, 6, num_corr_channels(2, 1))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cost_volume_backward(g, f, f, 2)
    assert cost_volume_backward.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corr_layer_gradient_matches_jax(dtype):
    """Corr(d=2, t=3, keep='all') in float32, and on a bf16 window (the
    slice's model): the window's gradient against jax.vjp of the JAX Corr.
    The middle frame's gathers its own channels and both comparisons; the
    cast's backward hands the gradient back in the window's dtype."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 3, 7, 9, 5).astype(np.float32)
    if dtype == torch.bfloat16:
        x = torch.from_numpy(x).to(dtype).float().numpy()  # bf16 values on both sides
    jm = jlayers.Corr(2, 3, kernel_size=1, stride=1, keep="all")
    out, vjp = jax.vjp(lambda z: jm.apply({}, z), jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else None))
    ct = rs.randn(*out.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(ct))
    t = torch.from_numpy(x).to(dtype).requires_grad_()
    ours = layers.Corr(2, 3, kernel_size=1, stride=1, keep="all")(t)
    assert ours.dtype == torch.float32
    ours.backward(torch.from_numpy(ct))
    assert t.grad.dtype == dtype
    np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(jg, np.float32),
                               **(GRAD_TOL if dtype == torch.float32 else dict(rtol=0, atol=0)))
    # the middle frame: its own route, plus the adjoint of both cost volumes as f2
    mid = torch.from_numpy(ct[..., 5:10].copy())
    _, g0 = cost_volume_backward_plain(torch.from_numpy(ct[..., 15:40].copy()), t.detach()[:, 0].float(),
                                       t.detach()[:, 1].float(), 2, 1)
    _, g2 = cost_volume_backward_plain(torch.from_numpy(ct[..., 40:65].copy()), t.detach()[:, 2].float(),
                                       t.detach()[:, 1].float(), 2, 1)
    if dtype == torch.float32:
        torch.testing.assert_close(t.grad[:, 1], mid + g0 + g2, **GRAD_TOL)


def test_per_frame_cell_train_mode_matches_flax():
    """A conv cell over every frame of a (B, k, H, W, C) window in train
    mode (time folded into the batch): its output, the running statistics
    (flax's biased variance over the B*k frames) and the window's gradient
    against flax's time_distributed cell."""
    x = np.random.RandomState(12).randn(2, 3, 6, 5, 4).astype(np.float32)
    jm = jlayers.ConvBNLeaky(8, kernel=3)
    v = random_variables(jm, x[:, 0], seed=13)

    def jrun(z):  # flax's time_distributed, with the mutated statistics kept
        y, mutated = jm.apply(v, z.reshape((6,) + z.shape[2:]), train=True, mutable=["batch_stats"])
        return y.reshape((2, 3) + y.shape[1:]), mutated["batch_stats"]

    ref, stats = jrun(jnp.asarray(x))
    ct = np.random.RandomState(14).randn(*ref.shape).astype(np.float32)
    _, jvjp = jax.vjp(lambda z: jrun(z)[0], jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(ct))
    tm = layers.ConvBNLeaky(4, 8, kernel=3)
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    tm.train()
    t = torch.from_numpy(x).requires_grad_()
    ours = layers.time_distributed(lambda z: tm(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), t)
    ours.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)
    theirs = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
    for k in ("BatchNorm_0.running_mean", "BatchNorm_0.running_var"):
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), theirs[k].numpy(), rtol=1e-5, atol=1e-6)


def test_reference_pallas_kernel_has_no_gradient():
    """The JAX package's K2, `correlation_pallas`, has no custom_vjp: jax.grad
    through it (interpret mode on the CPU) fails in JAX's pallas_call JVP
    rule, while its XLA form differentiates.  The JAX package sends every
    non-CPU correlation there (ops/correlation.py:55-62), so its corr
    training off the CPU cannot differentiate the kernel (ROADMAP.md Queue
    3); the port differentiates K2 through its own adjoint kernel."""
    rs = np.random.RandomState(15)
    f1, f2 = (jnp.asarray(rs.randn(1, 8, 8, 4).astype(np.float32)) for _ in range(2))
    with pytest.raises(Exception):
        jax.grad(lambda a, b: correlation_pallas(a, b, 2, interpret=True).sum(), argnums=(0, 1))(f1, f2)
    g1, g2 = jax.grad(lambda a, b: jax_correlation(a, b, 2, 1, 1, 1).sum(), argnums=(0, 1))(f1, f2)
    p1, p2 = cost_volume_backward_plain(torch.ones(1, 8, 8, 25), torch.from_numpy(np.asarray(f1)),
                                        torch.from_numpy(np.asarray(f2)), 2, 1)
    np.testing.assert_allclose(p1.numpy(), np.asarray(g1), **GRAD_TOL)
    np.testing.assert_allclose(p2.numpy(), np.asarray(g2), **GRAD_TOL)
