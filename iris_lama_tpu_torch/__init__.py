"""iris_lama_tpu_torch — the PyTorch/CUDA port of iris_lama_tpu.

The same sparse-dense patch maps, fused occupancy + distance-field scan
update and Gauss-Newton IRLS scan matching, written as plain PyTorch on
tensors plus hand-written CUDA kernels for the hot spots (``csrc/``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel is replaced by its plain PyTorch
version in the same module.

Public API re-exports (loaded on first use, so ``import
iris_lama_tpu_torch`` stays light):

    from iris_lama_tpu_torch import Slam2D, Slam2DOptions, Pose2D
"""

__version__ = "0.1.0"

_EXPORTS = {
    "Pose2D": "core.pose", "Pose3D": "core.pose",
    "Slam2D": "algos.slam2d", "Slam2DOptions": "algos.slam2d",
    "Loc2D": "algos.loc2d", "Loc2DOptions": "algos.loc2d",
    "PFSlam2D": "algos.pf_slam2d", "PFSlam2DOptions": "algos.pf_slam2d",
    "GraphSlam2D": "algos.graph_slam2d",
    "GraphSlam2DOptions": "algos.graph_slam2d",
    "SimplePGO": "algos.simple_pgo",
    "LidarOdometry2D": "algos.lidar_odometry_2d",
    "LidarOdometry2DOptions": "algos.lidar_odometry_2d",
    "PointCloudXYZ": "utils.cloud",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'iris_lama_tpu_torch' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{module}", __name__), name)
