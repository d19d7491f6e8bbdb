"""VideoYOLO in PyTorch for NVIDIA Hopper (H100).

The counterpart of `videoyolo_tpu`: module paths and class names mirror that
package, so `videoyolo_torch.models.yolo3.YOLOv3` is the port of
`videoyolo_tpu.models.yolo3.YOLOv3`.  This package imports `torch` and never
`jax`, `flax` or `videoyolo_tpu`; what it needs from framework-free modules
there, it keeps its own copy of.

Public functions keep the JAX package's layouts (NHWC images in, `(B, N, 4)`
boxes, `(B, N, C)` scores, `(B, P, 6)` detections out); inside, the convs run
NCHW in `channels_last` memory.  Entry points run on the card unless the
caller passes `device="cpu"` (see `device.py`).
"""
