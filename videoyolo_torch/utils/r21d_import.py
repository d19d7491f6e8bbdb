"""VMZ (caffe2) R(2+1)D checkpoint import into the port's `R21D` (port of
videoyolo_tpu/utils/r21d_import.py:1-107).

The VMZ model zoo's `.pkl` checkpoints (IG65M / Kinetics / Sports1M) are
pickled `{'blobs': {name: ndarray}}` dicts in caffe2's blob names:

  conv1_middle_w, conv1_middle_spatbn_relu_{s,b,rm,riv}, conv1_w,
  conv1_spatbn_relu_{s,b,rm,riv}                       (the init 2+1D conv)
  comp_<i>_conv_<j>_middle_w, comp_<i>_spatbn_<j>_middle_*,
  comp_<i>_conv_<j>_w, comp_<i>_spatbn_<j>_*           (block i, conv j=1,2)
  shortcut_projection_<k>_w, shortcut_projection_<k>_spatbn_*
  last_out_L<classes>_{w,b}                             (the classifier)

A conv blob is caffe2's NCDHW (out, in, T, H, W), which is torch's
`Conv3d` weight layout as it is: the port takes it without the transpose
the JAX package makes into flax's (T, H, W, in, out); the classifier's
(out, in) is `nn.Linear`'s.  The JAX package's rules hold: every blob's
shape equals its target's (ValueError here, AssertionError there); `riv`
goes into the running variance as it is (no inversion); a stage's
shortcut projection is numbered by the index of its first block and
loaded where the blob exists; the classifier only into a model that has
`dense`.  The JAX importer walks `conv1/spatial` and `conv2/spatial` of
every block, which the 152-layer network's bottleneck blocks (a 1x1x1
`conv1`) do not have, so it fails on that tree with a KeyError; the port
refuses it with that reason (ROADMAP.md Queue 3).

The file is unpickled: load only checkpoints from a trusted source.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
from torch import nn

from ..models.r21d import R21D, Bottleneck21D

__all__ = ["load_vmz_r21d"]

_LAYERS = {34: (3, 4, 6, 3), 152: (3, 8, 36, 3)}
_BN = {"s": "weight", "b": "bias", "rm": "running_mean", "riv": "running_var"}


def _target(model: nn.Module) -> R21D:
    if isinstance(model, R21D):
        return model
    if isinstance(getattr(model, "r21d", None), R21D):
        return model.r21d
    raise ValueError(f"load_vmz_r21d loads into an R21D or the r21d child of a TwoStreamDarknet, got "
                     f"{type(model).__name__}")


def load_vmz_r21d(model: nn.Module, path: str, n_layers: int = 34) -> nn.Module:
    """Load a VMZ `.pkl` into `model` (an `R21D`, any of its output modes,
    or a `TwoStreamDarknet(stream="r21d")`'s `r21d`) in place; returns
    `model`.  A missing blob raises KeyError."""
    if n_layers not in _LAYERS:
        raise ValueError(f"VMZ ships 34 and 152 layer R(2+1)D nets, got n_layers={n_layers}")
    net = _target(model)
    if any(isinstance(m, Bottleneck21D) for m in net.modules()):
        raise ValueError(
            "the 152-layer R(2+1)D (bottleneck blocks): the JAX package's importer walks conv1/spatial and "
            "conv2/spatial of every block, and a bottleneck block's conv1 is a 1x1x1 conv with no spatial half, "
            "so its load fails with a KeyError; not ported (ROADMAP.md Queue 3)")
    with open(path, "rb") as f:
        blobs = pickle.load(f, encoding="latin1")["blobs"]
    state = net.state_dict()

    def put(key: str, value):
        value = np.asarray(value)
        cur = state[key]
        if tuple(cur.shape) != value.shape:
            raise ValueError(f"{key}: the checkpoint's {value.shape}, the model's {tuple(cur.shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value)).to(cur.dtype)

    def put_bn(module: str, prefix: str):
        for suffix, leaf in _BN.items():
            put(f"{module}.{leaf}", blobs[f"{prefix}_{suffix}"])

    put("init.spatial.weight", blobs["conv1_middle_w"])
    put_bn("init.mid_bn", "conv1_middle_spatbn_relu")
    put("init.temporal.weight", blobs["conv1_w"])
    put_bn("init_bn", "conv1_spatbn_relu")
    comp = 0
    for si, nblocks in enumerate(_LAYERS[n_layers], start=1):
        stage_start = comp
        for bi in range(1, nblocks + 1):
            name = f"stage{si}_block{bi}"
            for j in (1, 2):
                put(f"{name}.conv{j}.spatial.weight", blobs[f"comp_{comp}_conv_{j}_middle_w"])
                put_bn(f"{name}.conv{j}.mid_bn", f"comp_{comp}_spatbn_{j}_middle")
                put(f"{name}.conv{j}.temporal.weight", blobs[f"comp_{comp}_conv_{j}_w"])
                put_bn(f"{name}.bn{j}", f"comp_{comp}_spatbn_{j}")
            sk = f"shortcut_projection_{stage_start}"
            if bi == 1 and f"{sk}_w" in blobs:
                put(f"{name}.down.weight", blobs[f"{sk}_w"])
                put_bn(f"{name}.down_bn", f"{sk}_spatbn")
            comp += 1
    cls_key = next((k for k in blobs if k.startswith("last_out_L") and k.endswith("_w")), None)
    if cls_key and hasattr(net, "dense"):
        put("dense.weight", blobs[cls_key])
        put("dense.bias", blobs[cls_key[:-2] + "_b"])
    net.load_state_dict(state, strict=True)
    return model
