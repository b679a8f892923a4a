"""Inference post-processing."""
