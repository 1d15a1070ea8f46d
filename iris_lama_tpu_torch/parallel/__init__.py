"""Batch and multi-device paths: the map rebuild."""
