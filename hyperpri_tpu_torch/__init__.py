"""PyTorch/CUDA port of hyperpri_tpu for NVIDIA Hopper (H100).

The JAX package `hyperpri_tpu` is the reference; this package imports none of
it. Entry points run on the CUDA card unless the caller passes a device.
"""

__version__ = "0.1.0"
