"""repro_torch: the PyTorch/CUDA port of the Gimbal serving stack.

Same module layout as the JAX reference package ``repro`` (configs, models,
kernels, core, serving, training), written for PyTorch on an NVIDIA Hopper
card.  The port never imports ``jax`` or ``repro``: what it shares with the
reference is copied, and the tests hold the two against each other.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
