"""FlowNet inference helpers, flow colouring, `.flo` files and the FlowNet2
weight import (port of videoyolo_tpu/models/flownet_utils.py:1-264).

The numpy helpers (`crop_to_64`, `normalise_pair`, the Middlebury colour
wheel, `flow_to_image`, `write_flo`, `read_flo`) are copies of the JAX
package's.  `process_two_images` and `process_imagedir` run a port FlowNet
(`models/flownet.py`, eval mode) on the card unless the caller asks for the
CPU; the frames of a directory are read through the JPEG core
(`data/base.read_image`).  `process_imagedir` writes each pair's `.flo`;
the JAX package also writes a colour PNG where cv2 imports, which the
port, with no PNG writer, leaves to ROADMAP.md Queue 1 item 15, as it
leaves `process_video` (frames of a video file need cv2).

`convert_torch_flownet` reads an NVIDIA FlowNet2-S checkpoint (`.pth`)
with `torch.load` straight into a port `FlowNetS`: the checkpoint's conv
and transposed-conv weights are in the port's own layouts, so the JAX
importer's key mapping is kept and its transposes are not needed.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "compute_color", "convert_torch_flownet", "crop_to_64", "flow_to_image", "make_color_wheel", "normalise_pair",
    "process_imagedir", "process_two_images", "read_flo", "write_flo",
]

UNKNOWN_FLOW_THRESH = 1e7

# --- pre/post processing (flownet_utils.py:22-36) ---------------------------


def crop_to_64(imgs: np.ndarray) -> np.ndarray:
    """Centre-crop H and W to multiples of 64 (the encoder's stride)."""
    h, w = imgs.shape[-3:-1]
    h64, w64 = (h // 64) * 64, (w // 64) * 64
    y0, x0 = (h - h64) // 2, (w - w64) // 2
    return imgs[..., y0 : y0 + h64, x0 : x0 + w64, :]


def normalise_pair(imgs: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float in the FlowNet2 training range (mean-subtracted
    /255)."""
    imgs = imgs.astype(np.float32) / 255.0
    return imgs - imgs.mean(axis=(-3, -2), keepdims=True)


# --- inference (flownet_utils.py:42-79) --------------------------------------


def process_two_images(model: torch.nn.Module, img1: np.ndarray, img2: np.ndarray, device=None) -> np.ndarray:
    """The flow between two HWC uint8 RGB frames, cropped to multiples of 64
    and normalised: (H/4, W/4, 2) float32.  `model` (a FlowNetS or FlowNetC)
    is moved to `device` (default the card; raises where there is none)
    and runs in eval mode."""
    dev = resolve_device(device)
    pair = normalise_pair(crop_to_64(np.stack([img1, img2])))
    model = model.to(dev).eval()
    with torch.inference_mode():
        flow = model(torch.from_numpy(pair)[None].to(dev))
    return flow[0].float().cpu().numpy()


def process_imagedir(model: torch.nn.Module, input_dir: str, output_dir: str | None = None, device=None):
    """The flow between consecutive frames of a directory (sorted by name),
    each written as `<output_dir>/<first frame's stem>.flo` (default
    `<input_dir>/flow`); returns the flows."""
    from ..data.base import read_image

    files = sorted(
        os.path.join(input_dir, f)
        for f in os.listdir(input_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    output_dir = output_dir or os.path.join(input_dir, "flow")
    os.makedirs(output_dir, exist_ok=True)
    outs = []
    for a, b in zip(files, files[1:]):
        flow = process_two_images(model, read_image(a), read_image(b), device)
        stem = os.path.splitext(os.path.basename(a))[0]
        write_flo(os.path.join(output_dir, stem + ".flo"), flow)
        outs.append(flow)
    return outs


# --- Middlebury flow colouring (flownet_utils.py:106-171) --------------------


def make_color_wheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    nan = np.isnan(u) | np.isnan(v)
    u, v = np.nan_to_num(u), np.nan_to_num(v)
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col0 = wheel[k0] / 255.0
    col1 = wheel[k1] / 255.0
    col = (1 - f) * col0 + f * col1
    idx = rad <= 1
    col[idx] = 1 - rad[idx, None] * (1 - col[idx])
    col[~idx] *= 0.75
    col[nan] = 0
    return np.floor(255 * col).astype(np.uint8)


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> RGB uint8."""
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    bad = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(-1.0, float(rad.max()))
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    img = compute_color(u, v)
    img[bad] = 0
    return img


def write_flo(filename: str, flow: np.ndarray):
    """Middlebury .flo export."""
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"a .flo holds an (H, W, 2) flow, got {flow.shape}")
    with open(filename, "wb") as f:
        np.float32(202021.25).tofile(f)  # magic
        np.int32(flow.shape[1]).tofile(f)
        np.int32(flow.shape[0]).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_flo(filename: str) -> np.ndarray:
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if abs(magic - 202021.25) >= 1e-3:
            raise ValueError(f"{filename}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        return np.fromfile(f, np.float32, h * w * 2).reshape(h, w, 2)


# --- FlowNet2 checkpoint import (flownet_utils.py:189-264) -------------------

_ENC_CONVS = ("conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1")
_DEC = (
    "predict_flow6", "predict_flow5", "predict_flow4", "predict_flow3", "predict_flow2",
    "deconv5", "deconv4", "deconv3", "deconv2",
    "upsampled_flow6_to_5", "upsampled_flow5_to_4", "upsampled_flow4_to_3", "upsampled_flow3_to_2",
)


def convert_torch_flownet(load_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load an NVIDIA FlowNet2-S checkpoint (`.pth`, optionally under
    "state_dict") into a port `FlowNetS` in place; returns the model.

    The checkpoint's encoder convs are `<name>.0.weight` / `.bias`
    (Sequential(conv, leaky)); its decoder's entries are `<name>.weight`
    or `<name>.0.weight`, with a bias where it has one.  A missing entry
    raises KeyError; an entry the model lacks, or of another shape,
    ValueError.  The model's other parameters stay as they were."""
    state = torch.load(load_path, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)

    entries: Dict[str, torch.Tensor] = {}
    for name in _ENC_CONVS:
        entries[f"encoder.{name}.weight"] = state[f"{name}.0.weight"]
        entries[f"encoder.{name}.bias"] = state[f"{name}.0.bias"]
    for name in _DEC:
        prefix = name if f"{name}.weight" in state else f"{name}.0"
        entries[f"decoder.{name}.weight"] = state[f"{prefix}.weight"]
        if f"{prefix}.bias" in state:
            entries[f"decoder.{name}.bias"] = state[f"{prefix}.bias"]

    params = dict(model.named_parameters())
    for key, value in entries.items():
        if key not in params or params[key].shape != value.shape:
            have = tuple(params[key].shape) if key in params else None
            raise ValueError(f"{key}: the checkpoint's {tuple(value.shape)} against the model's {have}")
    with torch.no_grad():
        for key, value in entries.items():
            params[key].copy_(value)
    return model
