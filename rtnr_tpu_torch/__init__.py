"""rtnr_tpu_torch: the PyTorch/CUDA port of ``rtnr_tpu`` for NVIDIA Hopper.

Counterpart of the JAX package ``rtnr_tpu`` (which stays the reference).
The port imports ``torch`` and numpy only: no JAX, and nothing of
``rtnr_tpu`` — the host-side pieces it needs (config, camera, scene, file
formats) are kept as its own copies.

Layout:
- ``config``, ``camera``, ``scene``: host-side copies (numpy): calibration
  files, trajectories, the npz and ``.oct`` scene caches.
- ``data``: PLY and ``.oct`` readers and writers; ``utils``: PNG I/O and
  U-Net checkpoints (flax ``.msgpack``, torch ``.pth.tar``).
- ``apps.render_trajectory``: the render CLI.
- ``ops.raster``: projection + the (pixel, depth) sort.
- ``ops.raster_resolve4``: the v4 resolve (K1 and K2 as one CUDA kernel),
  and the winners (K1) and expansion (K2) kernels on their own.
- ``ops.prefilter``: the bit-exact depth prefilter (plain torch).
- ``ops.conv``: 3x3 conv (K3) and 2x2/s2 transposed conv (K4) CUDA kernels.
- ``models``: the U-Net (inference), BN folding and weight conversion.
- ``pipeline``: ``render_rgbd``/``render_filtered``/``render_full`` and
  ``Renderer``.
- ``parallel``: several ranks on ``torch.distributed`` (point sharding,
  frame batching, row strips, the sharded differentiable raster).

Kernels are built from ``csrc/*.cu`` with ``nvcc`` at first use on a CUDA
tensor (``_build.py``); importing the package needs no GPU.
"""

from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.config import RenderConfig
from rtnr_tpu_torch.scene import Scene

__all__ = ["Camera", "RenderConfig", "Scene"]
