"""Model factory (port of videoyolo_tpu/models/factory.py:25-154).

It builds the 2D YOLOv3 / Darknet-53 detector and, for k > 1, the YOLOv3T
window model with the JAX factory's defaults (k_join_type "max", k_join_pos
"early"; pad_stem is ignored there, as in JAX).  The motion-stream, 3D and
YOLOv3Temporal branches raise and name the ROADMAP slice that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .yolo3 import YOLOv3
from .yolo3_temporal import YOLOv3T

__all__ = ["YoloConfig", "build_model", "yolo3_darknet53", "yolo3_no_backbone"]

_FAMILIES = "YOLOv3Temporal and the other backbones come with slice 5, see ROADMAP.md"


@dataclass(frozen=True)
class YoloConfig:
    """The fields of the JAX package's config that this slice builds or
    raises on; the others come with the slices that read them.  `dtype` is
    a torch dtype (None: float32)."""

    num_classes: int
    k: Optional[int] = None  # temporal window size
    k_join_type: Optional[str] = None  # max | mean | cat
    k_join_pos: Optional[str] = None  # early | late
    block_conv_type: str = "2"  # '2' | '3' | '21'
    rnn_pos: Optional[str] = None  # late | out
    corr_pos: Optional[str] = None  # early | late
    corr_d: Optional[int] = None
    motion_stream: Optional[str] = None  # flownet | r21d
    agnostic: bool = False
    new_model: bool = False
    temporal: bool = False
    t_out: bool = False
    remat: bool = False
    s2d_stem: bool = False
    pad_stem: bool = False  # zero-pad the RGB input to 4 channels
    dtype: object = None


def build_model(cfg: YoloConfig):
    """Config -> model instance (in training mode, as torch builds modules:
    call `.eval()` to detect)."""
    if cfg.motion_stream:
        raise NotImplementedError(f"two-stream backbones: {_FAMILIES}")
    if cfg.temporal or cfg.t_out:
        raise NotImplementedError(f"YOLOv3Temporal: {_FAMILIES}")
    if cfg.new_model:
        raise NotImplementedError(f"3D and hierarchical darknets: {_FAMILIES}")
    if cfg.k is not None and cfg.k > 1:
        return YOLOv3T(
            num_classes=cfg.num_classes,
            k=cfg.k,
            k_join_type=cfg.k_join_type or "max",
            k_join_pos=cfg.k_join_pos or "early",
            block_conv_type=cfg.block_conv_type,
            rnn_pos=cfg.rnn_pos,
            corr_pos=cfg.corr_pos,
            corr_d=cfg.corr_d,
            agnostic=cfg.agnostic,
            dtype=cfg.dtype,
        )
    return YOLOv3(
        num_classes=cfg.num_classes, agnostic=cfg.agnostic, remat=cfg.remat,
        s2d_stem=cfg.s2d_stem, pad_stem=cfg.pad_stem, dtype=cfg.dtype,
    )


def yolo3_darknet53(classes, dtype=None, **kwargs) -> YOLOv3:
    """`classes` may be a list of names or an int count."""
    num = classes if isinstance(classes, int) else len(classes)
    return build_model(YoloConfig(num_classes=num, dtype=dtype, **kwargs))


def yolo3_no_backbone(classes, agnostic: bool = False, dtype=None) -> YOLOv3:
    """Head-only model over pre-extracted (r1, r2, r3) routes."""
    num = classes if isinstance(classes, int) else len(classes)
    return YOLOv3(num_classes=num, agnostic=agnostic, use_backbone=False, dtype=dtype)
