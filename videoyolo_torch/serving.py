"""The detect step as an object (port of detect_yolo3.py:494-502).

`Detector` builds the model from a `YoloConfig`, takes the JAX package's
variables (nested numpy dicts) or a seeded random init, and maps an image
batch, or a batch of k-frame windows when `cfg.k > 1` (t-frame windows,
t = k or 5, for YOLOv3Temporal), to detections: forward, two-stage top-k,
greedy NMS (the CUDA kernel on the card), boxes clipped to the image.
Per-timestep outputs (`t_out`) go through `postprocess_tout`: T folded
into the batch, one NMS call on the B*T images.  With `quantize="int8"` it serves the fused-int8
YOLOv3 of `ops/quantize.py:quantize_fused` (detect_yolo3.py:346-386).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .data.transforms import MEAN, STD, to_normalized
from .device import resolve_device
from .models.factory import YoloConfig, build_model
from .models.layers import init_weights
from .models.s2d import pad_stem_cin
from .models.yolo3 import postprocess_tout
from .ops.quantize import quantize_fused, replace_quant
from .utils.flax_bridge import flax_to_state_dict, state_dict_to_flax, walk

NMS_THRESH = 0.45
NMS_TOPK = 400


class Detector:
    """images (B, S, S, 3), or windows (B, k, S, S, 3) when the model takes
    k > 1 frames, uint8 in [0, 255] or already normalised float -> (ids
    (B,100,1), scores (B,100,1), boxes (B,100,4) clipped to [0, S]), torch
    tensors on the detector's device; a window gets one set of detections,
    or with `cfg.t_out` one a frame: (B, k, 100, ...).  Padding rows
    have id and score -1 and, after the clip, boxes of 0, as in the JAX
    package.

    `variables`: the JAX package's variables; a standard 3-channel stem is
    refolded when `cfg.pad_stem` (YOLOv3 only: YOLOv3T and its backbones
    have a 3-channel stem).  None: seeded random weights.
    `dtype` (when given) replaces `cfg.dtype`.  `device` None means CUDA, and
    raises where there is none.

    `quantize="int8"` serves YOLOv3 fused-int8 in `dtype` (its tips and
    prediction convs).  Float variables (or the random init, drawn in
    float32) are quantised, calibrated on `calibration` (image batches, uint8
    or normalised, as requests are); the JAX package's int8 variables (the
    output of its `quantize_fused`) load as they are.  `ds_conv` "pallas"
    sends the eligible downsamples to K3; the default "direct" is the JAX
    package's.  Like the JAX package, the Detector keeps `ds_conv` and the
    calibration on the model, not in the config."""

    def __init__(
        self,
        cfg: YoloConfig,
        variables: Optional[Dict] = None,
        *,
        dtype: Optional[torch.dtype] = None,
        data_shape: int = 416,
        device=None,
        seed: int = 0,
        quantize: Optional[str] = None,
        calibration=None,
        ds_conv: str = "direct",
    ):
        self.device = resolve_device(device)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        self.dtype = cfg.dtype or torch.float32
        self.data_shape = data_shape
        k = (cfg.k or 5) if cfg.temporal or cfg.t_out else cfg.k
        self.frames = k if k is not None and k > 1 else None
        self._mean = torch.tensor(MEAN, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(STD, dtype=torch.float32, device=self.device)
        int8_vars = variables is not None and any(p[-1] == "qkernel" for p, _ in walk(variables))
        if quantize in ("int8_static", "int8_dynamic"):
            raise NotImplementedError(f"quantize={quantize!r} is deferred, see ROADMAP.md Queue 1 item 9a")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        if quantize and self.frames is not None:
            raise NotImplementedError("the int8 temporal family is deferred, see ROADMAP.md Queue 1 item 9a")
        if int8_vars and not quantize:
            raise ValueError("int8 variables serve with quantize='int8'")
        if not quantize:
            model = self._float_model(cfg, variables, seed)
        elif int8_vars:
            model = replace_quant(build_model(cfg), "fused", ds_conv=ds_conv)
            model.load_state_dict(flax_to_state_dict(variables), strict=True)
        else:
            if not calibration:
                raise ValueError("quantize='int8' calibrates: pass `calibration` image batches")
            fmodel = self._float_model(dataclasses.replace(cfg, dtype=torch.float32), variables, seed)
            batches = [self._normalized(b) for b in calibration]
            model, _ = quantize_fused(
                fmodel, state_dict_to_flax(fmodel.state_dict()), batches, ds_conv=ds_conv, dtype=self.dtype
            )
        self.model = model.eval().to(self.device, memory_format=torch.channels_last)

    def _float_model(self, cfg: YoloConfig, variables, seed: int):
        model = build_model(cfg)
        if variables is None:
            init_weights(model, torch.Generator().manual_seed(seed))
            return model
        if cfg.pad_stem and not (cfg.new_model or cfg.motion_stream) and "backbone" in variables["params"]:
            stem = variables["params"]["backbone"]["conv0"]["Conv_0"]["kernel"]
            if np.shape(stem)[2] == 3:
                variables = pad_stem_cin(variables, prefix="backbone")
        model.load_state_dict(flax_to_state_dict(variables), strict=True)
        return model

    def _normalized(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.device)
        s = self.data_shape
        item = (s, s, 3) if self.frames is None else (self.frames, s, s, 3)
        if tuple(x.shape[1:]) != item:
            raise ValueError(f"expected images (B, {', '.join(map(str, item))}), got {tuple(x.shape)}")
        if x.dtype == torch.uint8:
            x = to_normalized(x, self._mean, self._std, self.dtype)
        return x.to(self.dtype)

    @torch.inference_mode()
    def __call__(self, images):
        s = self.data_shape
        boxes, scores = self.model(self._normalized(images))
        ids, sc, bb = postprocess_tout(boxes, scores, nms_thresh=NMS_THRESH, nms_topk=NMS_TOPK)
        return ids, sc, bb.clamp(0, s)


def collect_boxes(out_dict, file, ids_i, sc_i, bb_i, shape):
    """One image's detections (numpy) -> the normalised [[cls, score,
    x1..y2]] entries of the prediction files (port of
    detect_yolo3.py:_collect_boxes)."""
    valid = np.where(ids_i.flat >= 0)[0]
    box = bb_i[valid, :] / shape  # normalise
    cls = ids_i.flat[valid].astype(int)
    score = sc_i.flat[valid]
    out_dict.setdefault(file, [])
    for c, s, b in zip(cls, score, box):
        out_dict[file].append([int(c), float(s)] + [float(v) for v in b])
