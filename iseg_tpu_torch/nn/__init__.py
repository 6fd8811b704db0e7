"""Layers: conv blocks, normalization, reusable blocks, heads (NCHW); attention (NHWC)."""
