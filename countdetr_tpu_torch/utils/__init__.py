"""Metric logging, visualization, trace readers, and the port's spans and counters."""
