"""Sparse-dense maps: geometry, raycast, distance field, patch pool,
windows, the simple occupancy map and the fused SLAM map update."""
