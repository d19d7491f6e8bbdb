"""Weights carried across from the JAX package.

Input: the JAX package's variables as a nested dict of numpy arrays,
`{"params": ..., "batch_stats": ...}`.  Output: the port's `state_dict`.
The port names its submodules after the flax tree paths
(`backbone.stage1.ConvBNLeaky_0.Conv_0`, `block0`, `output0.prediction`,
`transition0`, ...), so the bridge walks the tree and renames leaves only:

  params      kernel (HWIO) -> weight (OIHW)
              kernel (kt, kh, kw, I, O) -> weight (O, I, kt, kh, kw)   a 3-D conv
              kernel (in, out) -> weight (out, in)     a dense layer
              scale         -> weight (BatchNorm)
              bias          -> bias
              qkernel (HWIO int8) -> qkernel (OIHW)    the fused-int8 leaves
              wscale, xscale, oscale -> the same names (buffers)
  batch_stats mean          -> running_mean (+ num_batches_tracked = 0)
              var           -> running_var

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
            t = torch.as_tensor(arr)
            if leaf == "kernel" and t.dim() == 2:
                t = t.T
            elif leaf == "kernel" and t.dim() == 5:
                t = t.permute(4, 3, 0, 1, 2)
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
    kw -> kt, kh, kw, I, O for a 3-D conv), BatchNorm weight
    -> scale, running stats -> batch_stats; num_batches_tracked is dropped."""
    variables: Dict = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        *mods, leaf = key.split(".")
        arr = t.detach().cpu()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", {"running_mean": "mean", "running_var": "var"}[leaf]
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
        node[name] = np.ascontiguousarray(arr.float().numpy())
    return variables
