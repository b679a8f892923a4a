"""Metric logging and visualization."""
