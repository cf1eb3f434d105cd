"""Tensor math: quaternions, splines, robust-loss helpers, and the
RANSAC scoring kernel with its plain PyTorch version."""
