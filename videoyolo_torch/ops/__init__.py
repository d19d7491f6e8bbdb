"""Compute ops: anchors, box math, greedy NMS and its CUDA kernel."""
