"""Inference pipeline and host-side audio helpers."""
