"""Weights carried across from the JAX package.

Input: the JAX package's variables as a nested dict of numpy arrays,
`{"params": ..., "batch_stats": ...}`.  Output: the port's `state_dict`.
The port names its submodules after the flax tree paths
(`backbone.stage1.ConvBNLeaky_0.Conv_0`, `block0`, `output0.prediction`,
`transition0`, MobileNet's automatic `_DWSep_3._ConvBNReLU6_0.Conv_0` and
`_InvertedResidual_7._ConvBNReLU6_2.BatchNorm_0`, ...), so the bridge walks
the tree and renames leaves only:

  params      kernel (HWIO) -> weight (OIHW); a depthwise conv's
                  (kh, kw, 1, C) -> (C, 1, kh, kw) alike
              kernel (kt, kh, kw, I, O) -> weight (O, I, kt, kh, kw)   a 3-D conv
              kernel (in, out) -> weight (out, in)     a dense layer
              kernel (kh, kw, in, out) -> weight (in, out, kh, kw),
                  reversed in kh and kw                 a transposed conv
              scale         -> weight (BatchNorm)
              bias          -> bias
              qkernel (HWIO int8) -> qkernel (OIHW)    the int8 leaves
              qkernel (DHWIO int8) -> qkernel (O, I, kt, kh, kw)   a 3-D int8 cell
              wscale, xscale, oscale -> the same names (buffers)
  batch_stats mean          -> running_mean (+ num_batches_tracked = 0)
              var           -> running_var

A transposed conv is FlowNet's decoder's (`deconv{2..5}`,
`upsampled_flow{k}_to_{k-1}`, models/flownet.py), told by its module's
name: flax's `ConvTranspose` applies its kernel as it is, torch's
`conv_transpose2d` the weight reversed in kh and kw, so the bridge
reverses it both ways.

The s2d stem's leaves keep their paths: `conv0/Conv_0/kernel` (3, 3, 12,
128) and `stage1/ConvBNLeaky_0/Conv_0/kernel` (2, 2, 128, 64) map to
`conv0.Conv_0.weight` (128, 12, 3, 3) and `stage1.ConvBNLeaky_0.Conv_0.weight`
(64, 128, 2, 2); the stem's BatchNorm keeps its 32 channels.

`state_dict_to_flax` is the inverse for a float model (float32 master
parameters, trained or not): its state_dict as the JAX package's
variables, which ops/quantize.py converts and train/checkpoint.py writes
as flax msgpack.  Leaves may be numpy arrays or torch tensors (a bfloat16
leaf read from a checkpoint is a torch tensor: numpy has no bfloat16).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# the modules whose kernels are transposed convs' (models/flownet.py)
_TRANSPOSED = ("deconv", "upsampled_flow")

_LEAVES = {
    "params": {
        "kernel": "weight", "scale": "weight", "bias": "bias",
        "qkernel": "qkernel", "wscale": "wscale", "xscale": "xscale", "oscale": "oscale",
    },
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, array) of every leaf of a nested dict; torch tensors stay
    tensors."""
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from walk(value, path + (key,))
        else:
            yield path + (key,), value if isinstance(value, torch.Tensor) else np.asarray(value)


def flax_to_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX package variables (nested numpy dicts) -> the port's state_dict."""
    unknown = set(variables) - set(_LEAVES)
    if unknown:
        raise ValueError(f"no bridge for variable collections {sorted(unknown)}")
    state = {}
    for coll, names in _LEAVES.items():
        for path, arr in walk(variables.get(coll, {})):
            *mods, leaf = path
            if leaf not in names:
                raise ValueError(f"no bridge for {coll} leaf {'/'.join(path)}")
            # a numpy view may run backwards (the JAX FlowNet2 importer's
            # flipped kernels), which torch cannot wrap
            t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
            if leaf == "kernel" and t.dim() == 2:
                t = t.T
            elif leaf in ("kernel", "qkernel") and t.dim() == 5:
                t = t.permute(4, 3, 0, 1, 2)
            elif leaf == "kernel" and t.dim() == 4 and mods[-1].startswith(_TRANSPOSED):
                t = t.flip(0, 1).permute(2, 3, 0, 1)
            elif leaf in ("kernel", "qkernel"):
                if t.dim() != 4:
                    raise ValueError(f"{'/'.join(path)}: expected an HWIO conv kernel, got {tuple(t.shape)}")
                t = t.permute(3, 2, 0, 1)
            state[".".join(mods + [names[leaf]])] = t.contiguous()
            if leaf == "mean":
                state[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0, dtype=torch.long)
    return state


def state_dict_to_flax(state: Dict[str, torch.Tensor]) -> Dict:
    """A float model's state_dict -> the JAX package's variables (nested
    numpy dicts, float32): conv weights OIHW -> kernel HWIO (O, I, kt, kh,
    kw -> kt, kh, kw, I, O for a 3-D conv; a transposed conv's reversed
    back), BatchNorm weight
    -> scale, running stats -> batch_stats; num_batches_tracked is dropped."""
    variables: Dict = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        *mods, leaf = key.split(".")
        arr = t.detach()  # laid out on its own device, then copied to the host once
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", {"running_mean": "mean", "running_var": "var"}[leaf]
        elif leaf == "weight" and arr.dim() == 4 and mods[-1].startswith(_TRANSPOSED):
            coll, name, arr = "params", "kernel", arr.permute(2, 3, 0, 1).flip(0, 1)
        elif leaf == "weight" and arr.dim() == 4:
            coll, name, arr = "params", "kernel", arr.permute(2, 3, 1, 0)
        elif leaf == "weight" and arr.dim() == 5:
            coll, name, arr = "params", "kernel", arr.permute(2, 3, 4, 1, 0)
        elif leaf == "weight" and arr.dim() == 2:
            coll, name, arr = "params", "kernel", arr.T
        elif leaf == "weight" and arr.dim() == 1:
            coll, name = "params", "scale"
        elif leaf == "bias":
            coll, name = "params", "bias"
        else:
            raise ValueError(f"no bridge for state_dict entry {key} {tuple(arr.shape)}")
        node = variables[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = arr.float().contiguous().cpu().numpy()
    return variables
