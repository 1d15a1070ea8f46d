"""Sparse-dense maps: geometry, raycast, distance field, patch pool,
windows, the standalone occupancy maps, the fused SLAM map update, and
maps on disk (.smd files, image and mesh export)."""
