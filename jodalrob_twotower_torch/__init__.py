"""PyTorch/CUDA port of the two-tower retrieval engine, for one NVIDIA H100.

The JAX package ``jodalrob_twotower_tpu`` is the reference this package is
checked against; module names here follow it so each counterpart is easy to
find. This package imports ``torch`` and never JAX, flax, optax or anything
of the JAX package.

Entry points take ``device=None``, which means ``"cuda"``; without a card
they raise instead of running on the CPU. The CPU runs only when the caller
asks for it (the parity tests pass ``device="cpu"``), and there every hand
kernel's wrapper uses the kernel's plain PyTorch version.
"""

from jodalrob_twotower_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
