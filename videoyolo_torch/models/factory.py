"""Model factory (port of videoyolo_tpu/models/factory.py:25-154).

It builds the 2D YOLOv3 / Darknet-53 detector, for k > 1 the YOLOv3T
window model with the JAX factory's defaults (k_join_type "max", k_join_pos
"early"; pad_stem is ignored there, as in JAX) and its `block_conv_type`
and `rnn_pos`, and with `temporal` or `t_out` the t=5 YOLOv3Temporal (t = k
or 5, conv = block_conv_type, corr_d or 0).  Since k_join_type defaults to
"max", a late join always pre-empts the late correlation here, as in the
JAX factory: a YOLOv3T with corr_pos="late" and no join is built directly.
`new_model` builds YOLOv3T over a backbone that returns the routes itself:
`HDarknet(hierarchical, h_join_type or "max")` with k = 1 when
hierarchical[0] > 1, else `Darknet3D(conv_types, funnel_time)` with k = k or
1, the temporal flags passed as they are (factory.py:104-135).
`motion_stream="flownet"` (k = 3, factory.py:64-65) or `"r21d"` (k = 9 or
33, factory.py:66-67; the JAX factory's assertions are ValueErrors here)
builds YOLOv3T over the two-stream `TwoStreamDarknet(stream, add_type)`
with no temporal flag, as the JAX factory does (factory.py:74-88).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .darknet3d import Darknet3D
from .h_darknet import HDarknet
from .ts_darknet import TwoStreamDarknet
from .yolo3 import YOLOv3
from .yolo3_temporal import YOLOv3T, YOLOv3Temporal

__all__ = ["YoloConfig", "build_model", "yolo3_darknet53", "yolo3_3ddarknet", "yolo3_no_backbone"]



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
    add_type: Optional[str] = None  # the motion stream's gating: add | mul
    agnostic: bool = False
    new_model: bool = False
    hierarchical: Sequence[int] = (1, 1, 1, 1, 1)
    h_join_type: Optional[str] = None  # max | conv
    temporal: bool = False
    t_out: bool = False
    remat: bool = False
    s2d_stem: bool = False
    pad_stem: bool = False  # zero-pad the RGB input to 4 channels
    conv_types: Sequence[int] = (2, 2, 2, 2, 2, 2)
    funnel_time: bool = False
    dtype: object = None


def build_model(cfg: YoloConfig):
    """Config -> model instance (in training mode, as torch builds modules:
    call `.eval()` to detect)."""
    if cfg.motion_stream is not None:
        if cfg.motion_stream not in ("flownet", "r21d"):
            raise ValueError(f"motion_stream must be 'flownet' or 'r21d', got {cfg.motion_stream!r}")
        if cfg.motion_stream == "flownet" and cfg.k != 3:
            raise ValueError(f"the flownet stream requires k=3 (factory.py:64-65), got k={cfg.k}")
        if cfg.motion_stream == "r21d" and cfg.k not in (9, 33):
            raise ValueError(f"the r21d stream requires k in {{9,33}} (factory.py:66-67), got k={cfg.k}")
        backbone = TwoStreamDarknet(stream=cfg.motion_stream, t=cfg.k, add_type=cfg.add_type, dtype=cfg.dtype)
        return YOLOv3T(num_classes=cfg.num_classes, k=cfg.k, backbone=backbone, agnostic=cfg.agnostic,
                       dtype=cfg.dtype)
    if cfg.temporal or cfg.t_out:
        return YOLOv3Temporal(
            num_classes=cfg.num_classes, t=cfg.k or 5, conv=int(cfg.block_conv_type), corr_d=cfg.corr_d or 0,
            t_out=cfg.t_out, agnostic=cfg.agnostic, dtype=cfg.dtype,
        )
    if cfg.new_model:
        if cfg.hierarchical[0] > 1:
            backbone = HDarknet(windows=tuple(cfg.hierarchical), merge_type=cfg.h_join_type or "max", dtype=cfg.dtype)
            k = 1
        else:
            backbone = Darknet3D(conv_types=tuple(cfg.conv_types), funnel_time=cfg.funnel_time, dtype=cfg.dtype)
            k = cfg.k or 1
        return YOLOv3T(
            num_classes=cfg.num_classes, k=k, k_join_type=cfg.k_join_type, k_join_pos=cfg.k_join_pos,
            block_conv_type=cfg.block_conv_type, rnn_pos=cfg.rnn_pos, corr_pos=cfg.corr_pos, corr_d=cfg.corr_d,
            backbone=backbone, agnostic=cfg.agnostic, dtype=cfg.dtype,
        )
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


def yolo3_3ddarknet(classes, conv_types=(2, 2, 2, 2, 2, 2), agnostic=False, dtype=None, **kwargs) -> YOLOv3T:
    """The 3-D darknet detector (factory.py:138-145)."""
    num = classes if isinstance(classes, int) else len(classes)
    return build_model(YoloConfig(num_classes=num, new_model=True, conv_types=tuple(conv_types), agnostic=agnostic,
                                  dtype=dtype, **kwargs))


def yolo3_no_backbone(classes, agnostic: bool = False, dtype=None) -> YOLOv3:
    """Head-only model over pre-extracted (r1, r2, r3) routes."""
    num = classes if isinstance(classes, int) else len(classes)
    return YOLOv3(num_classes=num, agnostic=agnostic, use_backbone=False, dtype=dtype)
