"""Build and launch of the hand-written CUDA kernels (``csrc/*.cu``)."""
from ._build import BUILD_DIR, build, launch, sm_count

__all__ = ["BUILD_DIR", "build", "launch", "sm_count"]
