"""PyTorch/CUDA port of deepfake_tpu for one NVIDIA H100.

The JAX package (``deepfake_tpu``) stays the reference. This package imports
``torch`` and never ``jax`` or ``deepfake_tpu``: the modules it needs from
there are copied (``config.py``) or rewritten. Public inputs keep the JAX
contract (NTHWC frames, NHWC mel images, ``[B, T]`` waves) so one numpy array
feeds both packages.

Every Pallas kernel on the serving path has a hand-written CUDA kernel here
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/build.py``) and called through ``ctypes``.
"""

from deepfake_tpu_torch.config import Config

__all__ = ["Config"]
