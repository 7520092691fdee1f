"""PyTorch/CUDA port of predictionio_tpu.

Mirrors the JAX package's module paths. Imports torch and numpy, never
jax or anything of ``predictionio_tpu``. Entry points run on the first
CUDA device unless the caller passes ``device="cpu"``
(``predictionio_tpu_torch.device.resolve_device``).
"""
