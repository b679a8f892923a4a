"""Counting-DETR in PyTorch for NVIDIA Hopper: the port of ``countdetr_tpu``.

Module names mirror the JAX package's, so each counterpart is easy to find.
This package imports torch and numpy only, and scipy for the exact host
matcher; the JAX package is its reference, and only the tests import both.
"""
