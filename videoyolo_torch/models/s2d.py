"""Stem weight refolding (numpy; copy of videoyolo_tpu/models/s2d.py:33-106).

`refold_stem_s2d` maps standard Darknet-53 variables onto
`Darknet53(s2d_stem=True)`, the same function evaluated on the
space-to-depth grid:

  conv0  (3x3/s1,  3->32  @ HxW)    ->  3x3/s1 conv, 12->128 @ H/2 x W/2
  down1  (3x3/s2, 32->64)           ->  2x2/s1 conv, 128->64, pad (1,0)

For output phase (po, qo) and tap (di, dj) of conv0, the input pixel
(2a+po+di, 2b+qo+dj) lies at s2d row a + (po+di)//2, phase (po+di)%2, so
every standard tap lands in exactly one (row offset, phase) slot of the
refolded kernel, zeros elsewhere.  The stride-2 down1 has po = qo = 0 and
row offsets {-1, 0}: a 2x2 kernel padded at the top and left.  Kernels are
HWIO, as in the JAX package's variables.

`pad_stem_cin` maps them onto `Darknet53(pad_stem=True)`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["refold_conv0", "refold_down1", "refold_stem_s2d", "pad_stem_cin"]


def refold_conv0(w: np.ndarray) -> np.ndarray:
    """(3, 3, C, F) stride-1 stem kernel -> (3, 3, 4C, 4F) s2d kernel."""
    k, _, c, f = w.shape
    if k != 3:
        raise ValueError(f"conv0 kernel {w.shape} is not 3x3")
    out = np.zeros((3, 3, 4 * c, 4 * f), w.dtype)
    for po in (0, 1):
        for qo in (0, 1):
            for di in (-1, 0, 1):
                u, pi = (po + di) // 2, (po + di) % 2
                for dj in (-1, 0, 1):
                    v, qi = (qo + dj) // 2, (qo + dj) % 2
                    out[
                        u + 1, v + 1,
                        (pi * 2 + qi) * c : (pi * 2 + qi + 1) * c,
                        (po * 2 + qo) * f : (po * 2 + qo + 1) * f,
                    ] = w[di + 1, dj + 1]
    return out


def refold_down1(w: np.ndarray) -> np.ndarray:
    """(3, 3, C, F) stride-2 kernel -> (2, 2, 4C, F) s2d-input kernel."""
    k, _, c, f = w.shape
    if k != 3:
        raise ValueError(f"down1 kernel {w.shape} is not 3x3")
    out = np.zeros((2, 2, 4 * c, f), w.dtype)
    for di in (-1, 0, 1):
        u, pi = di // 2, di % 2  # -1 -> (-1, 1); 0 -> (0, 0); 1 -> (0, 1)
        for dj in (-1, 0, 1):
            v, qi = dj // 2, dj % 2
            out[u + 1, v + 1, (pi * 2 + qi) * c : (pi * 2 + qi + 1) * c] = w[di + 1, dj + 1]
    return out


def _mutable(tree):
    if hasattr(tree, "items"):
        return {k: _mutable(v) for k, v in tree.items()}
    return tree


def pad_stem_cin(variables: Dict, prefix: str = "") -> Dict:
    """Standard Darknet53 variables -> Darknet53(pad_stem=True) variables.

    Only conv0's kernel changes: (3, 3, 3, F) -> (3, 3, 4, F) with a zero
    4th input-channel row.  The padded model zero-pads its RGB input to 4
    channels, so the extra row never contributes.  `prefix` is the backbone
    scope ('' for a bare Darknet53, 'backbone' inside YOLOv3)."""
    out = _mutable(dict(variables))
    root = out["params"][prefix] if prefix else out["params"]
    w0 = np.asarray(root["conv0"]["Conv_0"]["kernel"])
    k, _, c, f = w0.shape
    if c != 3:
        raise ValueError(f"conv0 kernel {w0.shape} is not a 3-channel stem")
    root["conv0"]["Conv_0"]["kernel"] = np.concatenate(
        [w0, np.zeros((k, k, 1, f), w0.dtype)], axis=2
    )
    return out


def refold_stem_s2d(variables: Dict, prefix: str = "") -> Dict:
    """Standard Darknet53 variables -> Darknet53(s2d_stem=True) variables.

    Only conv0's kernel, (3, 3, 3, 32) -> (3, 3, 12, 128), and stage1's
    downsample kernel, (3, 3, 32, 64) -> (2, 2, 128, 64), change; the
    BatchNorm leaves carry over (the s2d stem keeps per-channel
    statistics).  The leaf paths stay: `conv0/Conv_0/kernel`,
    `stage1/ConvBNLeaky_0/Conv_0/kernel`.  `prefix` as in `pad_stem_cin`."""
    out = _mutable(dict(variables))
    root = out["params"][prefix] if prefix else out["params"]
    root["conv0"]["Conv_0"]["kernel"] = refold_conv0(np.asarray(root["conv0"]["Conv_0"]["kernel"]))
    down = root["stage1"]["ConvBNLeaky_0"]["Conv_0"]
    down["kernel"] = refold_down1(np.asarray(down["kernel"]))
    return out
