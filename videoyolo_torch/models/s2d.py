"""Stem weight refolding (numpy; copy of videoyolo_tpu/models/s2d.py:67-89).

Only the input-channel padding is ported; the space-to-depth refold comes
with the s2d stem (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["pad_stem_cin"]


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
