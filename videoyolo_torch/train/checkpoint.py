"""Checkpoints in the JAX package's format, with its save / resume / GC
policies (port of videoyolo_tpu/train/checkpoint.py:32-157).

A checkpoint is one `.params` file of flax msgpack holding `{"params",
"batch_stats"}` as nested dicts (utils/flax_msgpack.py), so the JAX
package's `load_variables` reads what `save_variables` writes here, and the
other way round.  `variables_of` and `load_into` carry a model's state
across the bridge (utils/flax_bridge.py).
"""
from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional, Tuple

from torch import nn

from ..utils.flax_bridge import flax_to_state_dict, state_dict_to_flax, walk
from ..utils.flax_msgpack import from_bytes, to_bytes

__all__ = [
    "save_variables", "load_variables", "load_detector_params", "save_params", "resume_params",
    "find_latest", "variables_of", "load_into",
]

# the container magic of MXNet's `.params` files (mx.nd.save)
MXNET_MAGIC = 0x112


def variables_of(model: nn.Module) -> Dict[str, Any]:
    """A float model's state as the JAX package's variables (float32 numpy)."""
    return state_dict_to_flax(model.state_dict())


def load_into(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Load the JAX package's variables into `model` (every leaf required)."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def save_variables(path: str, variables: Dict[str, Any]) -> str:
    """Write `variables` to `path` atomically: a temporary file renamed over
    it, so a kill mid-write leaves no truncated `.params` for `find_latest`
    to pick (and the `.tmp` suffix keeps the partial file out of its glob)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = to_bytes(variables)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)
    return path


def load_variables(path: str, template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Read a flax msgpack file.  With `template` (nested dicts of arrays),
    the file must hold the same leaf paths with the same shapes."""
    with open(path, "rb") as f:
        variables = from_bytes(f.read())
    if template is not None:
        want = {p: tuple(a.shape) for p, a in walk(template)}
        got = {p: tuple(a.shape) for p, a in walk(variables) if p[0] in template}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))[:4]
            raise ValueError(f"{path} does not match the template: {diff}")
        variables = {k: variables[k] for k in template}
    return variables


def load_detector_params(path: str, variables: Dict[str, Any]) -> Dict[str, Any]:
    """Load a detector checkpoint into the shape of `variables`, sniffing the
    container: the JAX package's flax msgpack is read; an MXNet `.params`
    file (the reference's gluon checkpoints) raises."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if len(magic) == 8 and int.from_bytes(magic, "little") == MXNET_MAGIC:
        raise NotImplementedError(
            "reading MXNet .params checkpoints (utils/gluon_import.py) is deferred, "
            "see ROADMAP.md Queue 1 item 1"
        )
    return load_variables(path, variables)


def save_params(prefix: str, variables: Dict[str, Any], current_map: float, best_map: float,
                epoch: int, save_interval: int) -> float:
    """The reference's save policy; returns the (possibly raised) best mAP.

    A better mAP writes `<prefix>_best.params` and appends to
    `<prefix>_best_map.log`; a positive `save_interval` writes
    `<prefix>_<epoch:04d>.params` every that many epochs; a negative one
    writes every epoch and, on each |interval| boundary, deletes the epochs
    since the previous boundary."""
    current_map = float(current_map)
    if current_map > best_map:
        best_map = current_map
        save_variables(f"{prefix}_best.params", variables)
        with open(prefix + "_best_map.log", "a") as f:
            f.write(f"{epoch:04d}:\t{current_map:.4f}\n")
    if save_interval > 0 and epoch % save_interval == 0:
        save_variables(f"{prefix}_{epoch:04d}.params", variables)
    if save_interval < 0:
        save_variables(f"{prefix}_{epoch:04d}.params", variables)
        if epoch % -save_interval == 0:
            for d in range(max(0, epoch + save_interval + 1), epoch):
                stale = f"{prefix}_{d:04d}.params"
                if os.path.exists(stale):
                    os.remove(stale)
    return best_map


def _epoch_of(path: str) -> int:
    """The epoch of `{prefix}_{epoch:04d}.params` (the last '_' field), or -1."""
    try:
        return int(os.path.basename(path)[: -len(".params")].split("_")[-1])
    except ValueError:
        return -1


def find_latest(save_dir: str) -> Optional[str]:
    """The latest epoch checkpoint in `save_dir`: every `*.params` whose name
    ends in an epoch (`_best.params` does not)."""
    files = [f for f in glob.glob(os.path.join(save_dir, "*.params")) if _epoch_of(f) >= 0]
    if not files:
        return None
    return max(files, key=_epoch_of)


def resume_params(resume: str, start_epoch: int, save_dir: str,
                  template: Optional[Dict[str, Any]] = None) -> Tuple[Optional[Dict[str, Any]], int]:
    """The reference's resume: an explicit file (the epoch after its own when
    `start_epoch` < 0), or with `start_epoch` -1 the latest in `save_dir`.
    Returns (variables or None, the epoch to start from)."""
    if resume and resume.strip():
        path = resume.strip()
        variables = load_variables(path, template)
        if start_epoch < 0:
            e = _epoch_of(path)
            return variables, e + 1 if e >= 0 else 0
        return variables, start_epoch
    if start_epoch == -1:
        latest = find_latest(save_dir)
        if latest is None:
            return None, 0
        return load_variables(latest, template), _epoch_of(latest) + 1
    return None, max(start_epoch, 0)
