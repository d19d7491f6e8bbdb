"""Post-training int8 quantisation for serving (port of
videoyolo_tpu/ops/quantize.py).

The conversion works on the JAX package's variable layout (nested numpy
dicts, `utils/flax_bridge.py`), so both packages give the same bits:
`fold_bn_cell`, `quantize_cell`, `quantize_detector_variables` and
`_insert_fused_scales` are copies of the JAX package's numpy code.  Every
conv-BN-leaky cell folds its BatchNorm into the kernel (w' = w *
gamma/sqrt(var+eps), b' = beta - mean * gamma/sqrt(var+eps)) and is quantised
symmetrically per output channel (wscale_c = max|w'[..., c]| / 127); the
prediction convs stay real-valued.

`quantize_fused` is the fused int8-end-to-end conversion of YOLOv3: a
calibration pass ("fused_calib": dynamic scales, recording each cell's input
and output amax and each residual join's amax) gives every cell its `oscale`
(and the stem its `xscale`) and every join its `xscale`.

`quantize_static` is the static conversion of YOLOv3 and its temporal
family (YOLOv3T with the built-in stages, YOLOv3Temporal): the dynamic
model (`quant=True`, a scale per image computed on the fly) runs over the
calibration batches, and `calibrate_detector_variables` gives every cell
the `xscale` of the largest amax it saw (numpy's float32 division, copied
from the JAX package).  The dynamic mode itself needs no calibration: its
variables are `quantize_detector_variables`'.

Deferred (ROADMAP.md Queue 1 item 9a): the two-stream int8 model (the
darknet side int8, the motion stream real-valued).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import numpy as np
import torch

from ..models.layers import BN_EPS, calibrating
from ..models.ts_darknet import TwoStreamDarknet
from ..models.yolo3 import YOLOv3
from ..models.yolo3_temporal import YOLOv3T, YOLOv3Temporal
from ..utils.flax_bridge import flax_to_state_dict

__all__ = [
    "fold_bn_cell",
    "quantize_cell",
    "quantize_detector_variables",
    "calibrate_detector_variables",
    "quantize_static",
    "quantize_fused",
    "assert_quantizable",
    "replace_quant",
]


def fold_bn_cell(kernel, gamma, beta, mean, var):
    """Fold BN (eps per models/layers.BN_EPS) into a conv kernel.
    kernel: (Kh, Kw, Cin, Cout) HWIO.  Returns (kernel', bias').

    Handles the space-to-depth stem cell (darknet.ConvBNLeakyS2D), whose BN
    pools statistics across the 4 spatial phases: its (C,) BN params fold
    into the 4C-channel conv by tiling (output channel j = phase*C + c uses
    BN channel c = j % C)."""
    kernel = np.asarray(kernel, np.float32)
    scale = np.asarray(gamma, np.float32) / np.sqrt(
        np.asarray(var, np.float32) + BN_EPS
    )
    b = np.asarray(beta, np.float32) - np.asarray(mean, np.float32) * scale
    cout = kernel.shape[-1]
    if scale.shape[0] != cout:
        rep = cout // scale.shape[0]
        assert scale.shape[0] * rep == cout, (scale.shape, kernel.shape)
        scale = np.tile(scale, rep)
        b = np.tile(b, rep)
    w = kernel * scale  # broadcasts over the trailing Cout axis
    return w, b


def quantize_cell(kernel, gamma, beta, mean, var) -> Dict[str, np.ndarray]:
    """One conv-BN cell -> {qkernel int8, wscale f32[Cout], bias f32[Cout]}.
    Kernel may be 2D (Kh, Kw, Cin, Cout) or 3D (Kt, Kh, Kw, Cin, Cout)."""
    w, b = fold_bn_cell(kernel, gamma, beta, mean, var)
    reduce_axes = tuple(range(w.ndim - 1))
    wscale = np.maximum(np.max(np.abs(w), axis=reduce_axes) / 127.0, 1e-12)
    qkernel = np.clip(np.round(w / wscale), -127, 127).astype(np.int8)
    return {
        "qkernel": qkernel,
        "wscale": wscale.astype(np.float32),
        "bias": b.astype(np.float32),
    }


def quantize_detector_variables(variables: Dict[str, Any]) -> Dict[str, Any]:
    """f32 {params, batch_stats} -> {params} for the int8 model.

    Walks the tree; every node shaped like a ConvBNLeaky scope (children
    `Conv_0` + `BatchNorm_0`) is replaced by its quantised cell; all other
    leaves (prediction convs, Dense heads) pass through unchanged."""
    stats = variables.get("batch_stats", {})

    def walk(p, s):
        if hasattr(p, "items"):
            if "Conv_0" in p and "BatchNorm_0" in p:
                bn_p = p["BatchNorm_0"]
                if not (hasattr(s, "items") and "BatchNorm_0" in s):
                    raise ValueError(
                        "quantize_detector_variables needs the batch_stats "
                        "collection to fold BatchNorm (params-only trees "
                        "cannot be quantized)"
                    )
                bn_s = s["BatchNorm_0"]
                return quantize_cell(
                    p["Conv_0"]["kernel"],
                    bn_p["scale"],
                    bn_p["bias"],
                    bn_s["mean"],
                    bn_s["var"],
                )
            return {
                k: walk(v, s[k] if hasattr(s, "items") and k in s else {})
                for k, v in p.items()
            }
        return p

    return {"params": walk(variables["params"], stats)}


def _insert_fused_scales(params, calib):
    """Insert the fused-mode scale params from the sown calibration tree:
    cells (nodes with `qkernel`) gain `xscale` (real-valued input only) and
    `oscale`; calib-only scopes with an `amax` (the QuantResidual joins,
    which have no params during calibration) are created with `xscale`."""

    def _scale(v):
        if isinstance(v, (tuple, list)):
            v = v[0]
        return np.float32(max(np.float32(v) / 127.0, 1e-12))

    def walk(p, c):
        if not hasattr(p, "items"):
            return p
        cmap = c if hasattr(c, "items") else {}
        if "qkernel" in p:
            out = dict(p)
            if "amax" in cmap:
                out["xscale"] = _scale(cmap["amax"])
            if "oamax" in cmap:
                out["oscale"] = _scale(cmap["oamax"])
            return out
        out = {k: walk(v, cmap.get(k, {})) for k, v in p.items()}
        for k, v in cmap.items():
            if k not in out and hasattr(v, "items") and "amax" in v:
                out[k] = {"xscale": _scale(v["amax"])}
        return out

    return walk(params, calib)


def assert_quantizable(model):
    """One predicate for 'can this model take the int8 path' (ops/quantize.py:127-150):
    YOLOv3, YOLOv3Temporal, and YOLOv3T with the built-in stages (the
    conv-RNN configurations in mixed precision).  A new_model backbone
    fails the JAX package's assertion with its message; the two-stream one
    is deferred."""
    if type(model) in (YOLOv3, YOLOv3Temporal):
        return
    if type(model) is YOLOv3T:
        backbone = getattr(model, "backbone", None)
        if isinstance(backbone, TwoStreamDarknet):
            raise NotImplementedError("the two-stream int8 model is deferred, see ROADMAP.md Queue 1 item 9a")
        assert backbone is None, (
            "int8 temporal backbones: built-in (2D/3D/2+1D blocks) or the "
            "two-stream family (darknet side int8, motion stream bf16)"
        )
        return
    raise AssertionError("int8 serving supports yolo3_darknet53 and its temporal variants")


def replace_quant(model, quant, **overrides):
    """A new model like `model` (its constructor arguments, `init_kwargs`)
    with `quant` and any `overrides`, in eval mode, not initialised."""
    return type(model)(**{**model.init_kwargs, "quant": quant, **overrides}).eval()


def _calibration_tree(model) -> Dict[str, Any]:
    """The amax each cell and join recorded, nested by module path as the
    JAX package's "quant_calib" collection is."""
    tree: Dict[str, Any] = {}
    for name, module in model.named_modules():
        record = getattr(module, "calib", None)
        if not record:
            continue
        node = tree
        for part in name.split(".") if name else ():
            node = node.setdefault(part, {})
        node.update({k: np.float32(v.item()) for k, v in record.items()})
    return tree


def _device(batch) -> torch.device:
    """The device of a calibration batch: a tensor, or the head-only model's
    tuple of routes."""
    return batch.device if isinstance(batch, torch.Tensor) else _device(batch[0])


def _load(model, params, device):
    model.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    return model.to(device, memory_format=torch.channels_last)


def calibrate_detector_variables(qmodel_dynamic, qvars: Dict[str, Any], batches: Iterable[torch.Tensor]):
    """Dynamic-quant variables -> static-quant variables (ops/quantize.py:239-280):
    `qvars` loaded into `qmodel_dynamic` (a `quant=True` model, not
    initialised) on the batches' device, the model run over `batches`, and
    every cell given `xscale` = max(amax / 127, 1e-12) of the largest amax
    it recorded, in numpy float32 as the JAX package computes it on the
    host."""
    batches = list(batches)
    if not batches:
        raise ValueError("need at least one calibration batch")
    model = _load(qmodel_dynamic, qvars["params"], _device(batches[0]))
    with torch.inference_mode(), calibrating():
        for x in batches:
            model(x)
    amax_tree = _calibration_tree(model)

    def insert(p, c):
        if hasattr(p, "items"):
            if "qkernel" in p:
                amax = c["amax"]
                if isinstance(amax, (tuple, list)):
                    amax = amax[0]
                xscale = np.maximum(np.float32(amax) / 127.0, 1e-12)
                return {**p, "xscale": np.float32(xscale)}
            return {
                k: insert(v, c[k]) if hasattr(c, "items") and k in c else v
                for k, v in p.items()
            }
        return p

    return {"params": insert(qvars["params"], amax_tree)}


def quantize_static(model, variables: Dict[str, Any], batches: Iterable[torch.Tensor], dtype=None):
    """The static int8 conversion (ops/quantize.py:153-160): a float model
    (YOLOv3 or its temporal family, for its configuration), its variables in
    the JAX package's layout and calibration batches (normalised NHWC images
    or windows on the device to calibrate on) -> (quant="static" model,
    converted variables {"params": ...}).  The int8 model lies on the
    batches' device, in `dtype` (default: the float model's)."""
    assert_quantizable(model)
    batches = list(batches)
    kw = {} if dtype is None else {"dtype": dtype}
    qvars = quantize_detector_variables(variables)
    qvars = calibrate_detector_variables(replace_quant(model, True, **kw), qvars, batches)
    qmodel = _load(replace_quant(model, "static", **kw), qvars["params"], _device(batches[0]))
    return qmodel, qvars


def quantize_fused(model: YOLOv3, variables: Dict[str, Any], batches: Iterable[torch.Tensor],
                   ds_conv: str = "direct", dtype=None):
    """The fused int8-end-to-end conversion: a float YOLOv3 (for its
    configuration), its variables in the JAX package's layout
    (`utils/flax_bridge.state_dict_to_flax` of its state_dict) and
    calibration batches (NHWC images, normalised, on the device to calibrate
    on) -> (quant="fused" model, converted variables {"params": ...}).

    The calibration runs on the batches' device, with the int8 kernels on the
    card.  The int8 model lies on that device too, in `dtype` (default: the
    float model's), with `ds_conv` "direct" or "pallas" (K3)."""
    assert_quantizable(model)
    if type(model) is not YOLOv3:
        raise ValueError("the fused int8 pipeline covers YOLOv3 (the temporal family serves with "
                         "quant='static' / 'dynamic': quantize_static)")
    batches = list(batches)
    if not batches:
        raise ValueError("quantize_fused needs at least one calibration batch")
    device = _device(batches[0])
    kw = {} if dtype is None else {"dtype": dtype}
    params = quantize_detector_variables(variables)["params"]
    calib_model = _load(replace_quant(model, "fused_calib", **kw), params, device)
    with torch.inference_mode():
        for x in batches:
            calib_model(x)
    params = _insert_fused_scales(params, _calibration_tree(calib_model))
    qmodel = _load(replace_quant(model, "fused", ds_conv=ds_conv, **kw), params, device)
    return qmodel, {"params": params}
