"""PyTorch + CUDA port of the MDM serving path.

A second package beside the JAX reference ``repro``, module for module
where the role matches.  It imports ``torch`` and numpy only, never
``jax`` and never ``repro``.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; on CPU tensors
every kernel wrapper computes its plain PyTorch version.
"""
