"""Models: Darknet-53, YOLOv3 and the config factory."""
