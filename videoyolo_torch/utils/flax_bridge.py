"""Weights carried across from the JAX package.

Input: the JAX package's variables as a nested dict of numpy arrays,
`{"params": ..., "batch_stats": ...}`.  Output: the port's `state_dict`.
The port names its submodules after the flax tree paths
(`backbone.stage1.ConvBNLeaky_0.Conv_0`, `block0`, `output0.prediction`,
`transition0`, ...), so the bridge walks the tree and renames leaves only:

  params      kernel (HWIO) -> weight (OIHW)
              scale         -> weight (BatchNorm)
              bias          -> bias
  batch_stats mean          -> running_mean (+ num_batches_tracked = 0)
              var           -> running_var

Reading a flax msgpack checkpoint file is deferred (see ROADMAP.md): the
card's machine has neither flax nor msgpack.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_LEAVES = {
    "params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _walk(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def flax_to_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX package variables (nested numpy dicts) -> the port's state_dict."""
    unknown = set(variables) - set(_LEAVES)
    if unknown:
        raise ValueError(f"no bridge for variable collections {sorted(unknown)}")
    state = {}
    for coll, names in _LEAVES.items():
        for path, arr in _walk(variables.get(coll, {})):
            *mods, leaf = path
            if leaf not in names:
                raise ValueError(f"no bridge for {coll} leaf {'/'.join(path)}")
            if leaf == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: expected an HWIO conv kernel, got {arr.shape}")
                arr = arr.transpose(3, 2, 0, 1)
            state[".".join(mods + [names[leaf]])] = torch.from_numpy(np.ascontiguousarray(arr))
            if leaf == "mean":
                state[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0, dtype=torch.long)
    return state
