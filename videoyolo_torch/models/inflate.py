"""2D -> 3D / 2+1D inflation of ImageNet Darknet-53 weights into
`Darknet3D` (port of videoyolo_tpu/models/inflate.py:29-128).

Both trees are the JAX package's variables (nested numpy dicts, the layout
`train/checkpoint.variables_of` gives):
  * a 3-D cell's kernel is the 2D kernel repeated over its time extent and
    divided by it (activation-preserving on static frames);
  * a 2+1D cell's spatial (1, k, k) kernel is the 2D kernel and its
    depthwise temporal kernel is uniform 1/tau;
  * a 2D cell's kernel is copied, and every BatchNorm's scale, bias, mean
    and variance come across.
The 52 cells of both models are walked in creation order, so any mix of
conv types inflates.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils.gluon_import import _flax_darknet_conv_paths, _get, _to_mutable
from .darknet3d import DARKNET_LAYERS

__all__ = ["inflate_darknet53_to_3d"]


def _units_3d() -> List[Tuple[str, ...]]:
    """The module path of each of Darknet3D's `_Unit`s, in Darknet-53's
    creation order of its cells."""
    units = [("stem",)]
    for i, n in enumerate(DARKNET_LAYERS):
        units.append((f"down{i}",))
        for j in range(n):
            units += [(f"stage{i}_block{j}", "_Unit_0"), (f"stage{i}_block{j}", "_Unit_1")]
    return units


def _unit_inner(node: Dict) -> Tuple[str, Dict]:
    """The one conv cell a _Unit wraps: (its name, its subtree)."""
    for key in node:
        if key.startswith(("ConvBNLeaky", "Conv21DRepPad")):
            return key, node[key]
    raise KeyError(f"no conv cell under {list(node)}")


def inflate_darknet53_to_3d(vars2d: Dict, vars3d: Dict) -> Dict:
    """`vars3d`, a Darknet3D variables tree, filled from a bare Darknet53's
    `vars2d`.  Each cell's kind is read off `vars3d` and each 3-D kernel is
    divided by its own time extent, as in the JAX package, whose
    `conv_types` and `tau` arguments the walk does not need.  Returns a new
    tree."""
    paths2d, units = _flax_darknet_conv_paths(), _units_3d()
    if not len(paths2d) == len(units) == 52:
        raise ValueError(f"{len(paths2d)} 2D cells against {len(units)} 3-D ones")
    p2, s2 = vars2d["params"], vars2d.get("batch_stats", {})
    out = _to_mutable(dict(vars3d))
    p3, s3 = out["params"], out.setdefault("batch_stats", {})

    for (conv_path, bn_path), mod_path in zip(paths2d, units):
        w2 = np.asarray(_get(p2, conv_path)["kernel"])  # (kh, kw, ci, co)
        bn2p, bn2s = _get(p2, bn_path), _get(s2, bn_path)
        key, cell_p = _unit_inner(_get(p3, mod_path))
        cell_s = _get(s3, mod_path)[key]
        if key.startswith("Conv21DRepPad"):
            sp, ss = cell_p["spatial"], cell_s["spatial"]
            sp["Conv_0"]["kernel"] = w2[None].astype(np.asarray(sp["Conv_0"]["kernel"]).dtype)
            _copy_bn(sp["BatchNorm_0"], ss["BatchNorm_0"], bn2p, bn2s)
            tk = np.asarray(cell_p["temporal"]["kernel"])
            cell_p["temporal"]["kernel"] = np.full_like(tk, 1.0 / tk.shape[0])
        else:
            conv = cell_p["Conv_0"]
            k3 = np.asarray(conv["kernel"])
            if k3.ndim == 5:  # a 3-D cell: repeated over its time extent, / that extent
                conv["kernel"] = (np.repeat(w2[None], k3.shape[0], axis=0) / float(k3.shape[0])).astype(k3.dtype)
            else:
                conv["kernel"] = w2.astype(k3.dtype)
            _copy_bn(cell_p["BatchNorm_0"], cell_s["BatchNorm_0"], bn2p, bn2s)
    return out


def _copy_bn(dst_p, dst_s, src_p, src_s):
    dst_p["scale"] = np.asarray(src_p["scale"], np.asarray(dst_p["scale"]).dtype)
    dst_p["bias"] = np.asarray(src_p["bias"], np.asarray(dst_p["bias"]).dtype)
    dst_s["mean"] = np.asarray(src_s["mean"], np.asarray(dst_s["mean"]).dtype)
    dst_s["var"] = np.asarray(src_s["var"], np.asarray(dst_s["var"]).dtype)
