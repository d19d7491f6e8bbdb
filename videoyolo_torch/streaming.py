"""Streaming video detection: sliding-window inference at one per-frame pass
a frame (port of videoyolo_tpu/streaming.py:86-411).

Windowed detection re-runs the whole k-frame window for every output, so
stride-1 detection over a video pays k per-frame passes a detection.  Every
YOLOv3T and YOLOv3Temporal configuration of the port runs a prefix of its
network on each frame alone; the stream runs that prefix once on each new
frame, keeps its outputs for the last k frames in buffers on the device,
and runs the rest of the network (the part that mixes the window), then the
NMS (K1 on the card), on the buffers.  Where the split falls:

* **tips** (YOLOv3T with 2D blocks and no correlation, with a plain late
  join or the output conv-RNN): the whole per-frame FPN is frame-pure, so
  the buffers hold the three pre-join tips (`YOLOv3T.fpn` on
  `frame_routes`) and the window's work is the join and the output convs,
  or the output GRUs over the window of tips (`YOLOv3T.outputs`);
* **routes** (every other YOLOv3T: early joins, the correlation early or
  late, the tip conv-RNN, 3D and 2+1D blocks; and YOLOv3Temporal's plain
  t_out path, with any blocks): the buffers hold the three
  per-frame routes and the window's work is the early join or correlation
  (K2 on the card), the FPN and the outputs;
* **stage1** (YOLOv3Temporal's correlation pyramid and funnel): the only
  per-frame work is stage 1, so the buffer holds one window of stage-1
  features and each step re-runs the correlation (K2 five times, under the
  kernel_size=3 patch sum, for the pyramid), the middle frame's stages 2-3
  or the funnel, and the head.

The halves are the model's own methods (models/yolo3_temporal.py), so the
stream and the windowed forward run the same modules on the same weights;
`split_temporal_variables` names the weights each half reads.

    stream = StreamingDetector(model)           # on its device, in eval mode
    ids, scores, boxes = stream.reset(frame0)   # buffers <- k copies of frame0's
    for frame in frames:
        ids, scores, boxes = stream.step(frame)

The contract, as the JAX package's: after reset(f0) and steps f1 .. fi,
step(fi) returns what the windowed model and `postprocess` return on the
window (f[i-k+1], ..., fi), left-padded with f0.  Models with per-timestep
outputs (t_out) fold T into the batch for the NMS and return (B, T, P, .)
detections, the window's T per-frame outputs each step.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, Mapping, Tuple

import torch

from .data.transforms import MEAN, STD, to_normalized
from .models.yolo3 import postprocess_tout
from .models.yolo3_temporal import YOLOv3T, YOLOv3Temporal

__all__ = [
    "StreamingDetector",
    "stream_frames",
    "split_temporal_variables",
    "make_streaming_step",
    "export_streaming_detector",
    "load_streaming_detector",
]

_STAGE_NAMES = ("stage1", "stage2", "stage3")
_TIP_NAMES = _STAGE_NAMES + ("block0", "block1", "block2", "transition0", "transition1")


def _tip_split_ok(model) -> bool:
    """The deep (tip) split is legal when the whole per-frame FPN is
    frame-pure: YOLOv3T with 2D blocks, no correlation, the built-in
    backbone, and time first mixed at the tips, by a plain late join or by
    the output conv-RNN (`rnn_pos="out"`: the blocks and tips run per frame
    and only the 1x1 output GRU scans the window).  `rnn_pos="late"` takes
    the route split: its tip GRU scans the window of block routes.  The JAX
    package's predicate (its int8 cases do not build in the port)."""
    if not (type(model) is YOLOv3T and model.corr_pos is None and model.block_conv_type == "2"):
        return False
    if model.rnn_pos == "out":
        return True
    return model.rnn_pos is None and model.k_join_pos == "late" and model.k_join_type is not None


def _embed_names(model) -> Tuple[str, ...]:
    """Top-level modules whose work is strictly per frame, for the route
    split: YOLOv3T and the plain t_out YOLOv3Temporal run the whole darknet
    per frame; the correlation pyramid and the funnel only stage 1."""
    if type(model) is YOLOv3T or (model.t_out and not model.corr_d):
        return _STAGE_NAMES
    return _STAGE_NAMES[:1]


def split_names(model) -> Tuple[str, ...]:
    """The top-level module names of the stream's per-frame half."""
    return _TIP_NAMES if _tip_split_ok(model) else _embed_names(model)


def split_temporal_variables(variables: Mapping, names=_STAGE_NAMES) -> Tuple[Dict, Dict]:
    """Split a temporal model's state_dict into (embed, head) by top-level
    module name: the per-frame `names` go to the embed half, every other
    key (blocks, transitions, outputs, the window-mixed stages) to the head
    half.  The JAX package splits its variable tree so; these are the same
    leaves under the bridge's names."""
    embed, head = {}, {}
    for key, value in variables.items():
        (embed if key.split(".", 1)[0] in names else head)[key] = value
    return embed, head


def _check_streamable(model) -> None:
    if getattr(model, "quant", None):
        raise NotImplementedError("the int8 stream is deferred, see ROADMAP.md Queue 1 item 9a")
    if type(model) is YOLOv3Temporal:
        if not model.t > 1:
            raise ValueError("streaming needs a temporal window (t=5)")
        if model.feed is not None:
            raise ValueError("the model is already a streaming head (feed)")
        return
    if type(model) is not YOLOv3T:
        raise ValueError("streaming covers the YOLOv3T and YOLOv3Temporal families (built-in darknet53 backbone)")
    if model.has_backbone:
        raise ValueError("streaming needs the built-in per-frame backbone (a custom temporal backbone such as "
                         "Darknet3D or HDarknet owns its time mixing), as in the JAX package")
    if model.feed is not None:
        raise ValueError("the model is already a streaming head (feed)")
    if not model.k > 1:
        raise ValueError("streaming needs a temporal window (k > 1)")


def _split_fns(model) -> Tuple[str, Callable, Callable]:
    """(split, embed_fn, window_fn) of a streamable `model`: embed_fn(frame
    (B, H, W, 3)) -> the per-frame half's tuple of outputs (three tips,
    three routes, or a 1-tuple of stage-1 features); window_fn(buffers) ->
    the model's (boxes, scores) on windows (B, k, ...) of them."""
    _check_streamable(model)
    if _tip_split_ok(model):
        return "tips", lambda frame: tuple(model.fpn(model.frame_routes(frame))), model.outputs
    if len(_embed_names(model)) == 3:
        if type(model) is YOLOv3Temporal:
            return "routes", lambda frame: tuple(model.frame_routes(frame)), model.head
        return ("routes", lambda frame: tuple(model.frame_routes(frame)),
                lambda bufs: model.head(model.window_routes(list(bufs))))
    return ("stage1", lambda frame: (model.frame_stage1(frame),),
            lambda bufs: model.head(model.routes_from_stage1(bufs[0])))


def _make_streaming_fns(
    model, nms_thresh: float = 0.45, nms_topk: int = 400, post_nms: int = 100,
) -> Tuple[str, Callable, Callable, Callable, Callable]:
    """(split, embed_fn, window_fn, head_fn, step_fn) of `model`: the first
    three as `_split_fns`'s; head_fn(buffers) -> (ids, scores, boxes), the
    window's half and the NMS; step_fn(buffers, frame) -> (buffers',
    detections), the buffers rolled by one frame."""
    split, embed_fn, window_fn = _split_fns(model)

    def head_fn(buffers):
        boxes, scores = window_fn(buffers)
        return postprocess_tout(boxes, scores, nms_thresh=nms_thresh, nms_topk=nms_topk, post_nms=post_nms)

    def step_fn(buffers, frame):
        buffers = tuple(torch.cat([buf[:, 1:], r[:, None]], dim=1) for buf, r in zip(buffers, embed_fn(frame)))
        return buffers, head_fn(buffers)

    return split, embed_fn, window_fn, head_fn, step_fn


def make_streaming_step(
    model, nms_thresh: float = 0.45, nms_topk: int = 400, post_nms: int = 100,
) -> Tuple[Callable, Callable]:
    """(embed_fn, step_fn) of `model` (see `_make_streaming_fns`): the pure
    stream step, buffers in and out, for a caller that keeps them."""
    _, embed_fn, _, _, step_fn = _make_streaming_fns(model, nms_thresh, nms_topk, post_nms)
    return embed_fn, step_fn


class StreamingDetector:
    """B streams of frames through `model` (a YOLOv3T or YOLOv3Temporal
    already on its device and in eval mode).  Frames are (B, H, W, 3): uint8
    in [0, 255], normalised on the device, or already normalised float.
    The buffers are tensors on the model's device in its dtype; B and the
    frame size are fixed by `reset`.  Detections: (ids (B, P, 1), scores
    (B, P, 1), boxes (B, P, 4)), (B, T, P, .) for t_out, boxes unclipped as
    `postprocess` returns them."""

    def __init__(self, model, nms_thresh: float = 0.45, nms_topk: int = 400, post_nms: int = 100):
        self.model = model
        self.split, self._embed, self._window, self._head, self._step = _make_streaming_fns(
            model, nms_thresh, nms_topk, post_nms)
        self.k = model.k if type(model) is YOLOv3T else model.t
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self._mean = torch.tensor(MEAN, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(STD, dtype=torch.float32, device=self.device)
        self._buffers = None

    def _frame(self, frame) -> torch.Tensor:
        x = torch.as_tensor(frame).to(self.device)
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected frames (B, H, W, 3), got {tuple(x.shape)}")
        if x.dtype == torch.uint8:
            x = to_normalized(x, self._mean, self._std, self.dtype)
        return x.to(self.dtype)

    @torch.inference_mode()
    def reset(self, frame):
        """Seed the buffers with k copies of `frame`'s per-frame outputs;
        returns the detections of the (frame, ..., frame) window, through
        the window's half only (rolling in frame again would leave the same
        buffers)."""
        self._buffers = tuple(
            r[:, None].expand((-1, self.k) + r.shape[1:]).contiguous() for r in self._embed(self._frame(frame))
        )
        return self._head(self._buffers)

    @torch.inference_mode()
    def step(self, frame):
        """Advance the streams by one frame -> the detections of the window
        ending at `frame`."""
        if self._buffers is None:
            raise RuntimeError("call reset(first_frame) first")
        self._buffers, dets = self._step(self._buffers, self._frame(frame))
        return dets

    @torch.inference_mode()
    def raw(self):
        """The model's (boxes, scores) on the window in the buffers, before
        the NMS."""
        return self._window(self._buffers)


def stream_frames(detector: StreamingDetector, frames: Iterable, anchor: str = "trail") -> Iterator:
    """One video's frames through `detector`; yields (frame index, dets).

    anchor="trail": the detections of the window ending at each frame (the
    stream's head left-padded with the first frame).  anchor="center": of
    the window centred on each frame, clamped at the clip's ends by edge
    repetition, as the VID window sampler builds it
    (data/imgnetvid.ImageNetVidDetection._window_ids): the windowed detect
    path's predictions for every frame, at one per-frame pass a frame.
    Emission lags k-1-k//2 frames behind the input, and the clip's tail is
    flushed by feeding the last frame again (the sampler's upper clamp).
    Exactly len(frames) pairs either way."""
    if anchor not in ("trail", "center"):
        raise ValueError(f"anchor must be 'trail' or 'center', got {anchor!r}")
    lag = detector.k - 1 - detector.k // 2 if anchor == "center" else 0
    last = None
    j = 0
    for f in frames:
        dets = detector.reset(f) if j == 0 else detector.step(f)
        last = f
        if j >= lag:
            yield j - lag, dets
        j += 1
    if j == 0:
        return
    for _ in range(lag):
        dets = detector.step(last)
        if j >= lag:
            yield j - lag, dets
        j += 1


def export_streaming_detector(*args, **kwargs):
    """The JAX package writes the stream step as a StableHLO artifact; the
    port's serving artifacts come with item 13."""
    raise NotImplementedError("the streaming artifact (export) is deferred, see ROADMAP.md Queue 1 item 13")


def load_streaming_detector(*args, **kwargs):
    raise NotImplementedError("the streaming artifact (load) is deferred, see ROADMAP.md Queue 1 item 13")
