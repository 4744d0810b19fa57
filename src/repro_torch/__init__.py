"""PyTorch / CUDA port of the 8-bit block-wise optimizers.

A second package beside ``repro`` (the JAX reference): the same modules at
the same relative paths with the same public names, held against the JAX
package by the differential tests under ``tests/test_torch_*.py``.  It
imports ``torch`` and never ``jax`` or ``repro``.

Every public entry point takes an explicit ``device`` (default ``"cuda"``)
and raises when CUDA is asked for and absent; the CPU is used only when the
caller passes ``device="cpu"``.  The kernels are CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` on first use; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.
"""
