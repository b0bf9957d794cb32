"""repro_torch — parallel order-based core maintenance on PyTorch and CUDA.

The port of the JAX package ``repro`` for an NVIDIA H100, laid out
module for module like it (``repro_torch/core/engine.py`` mirrors
``repro/core/engine.py``, and so on). It imports ``torch`` and
``numpy`` only: never ``jax``, and nothing of ``repro``. Labels are
int64, so nothing global has to be switched on.

Entry points run on the card unless the caller passes
``device="cpu"`` or CPU tensors. The hand-written Hopper kernels live in
``csrc/*.cu`` and build on first use into one library
(``kernels/build.py``); ``kernels/ops.py`` is the kernel API and
``models/recsys.py`` the DeepFM model that serves through it.
"""
__version__ = "1.0.0"
