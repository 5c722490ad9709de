"""PyTorch/CUDA port of the Helix serving reproduction.

A second package beside the JAX reference ``repro``: it imports ``torch``,
numpy and scipy, and nothing of ``jax`` or of ``repro``.  Module paths and
names mirror the reference (``repro_torch.models.attention`` <->
``repro.models.attention`` and so on), so each function has a counterpart
that the tests hold it against.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``; they never fall back to the CPU on
their own.
"""
