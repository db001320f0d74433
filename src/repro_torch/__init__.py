"""PyTorch/CUDA port of the FETI/Schur reproduction in ``repro``.

A second package beside the JAX reference: the same layout and names
(``core``, ``sparse``, ``fem``, ``feti``, ``kernels``, ``launch``,
``configs``), plain functions on tensors with a leading subdomain axis in
place of ``jax.vmap``, an explicit ``device`` (``cuda`` unless the caller
asks for the CPU), and hand-written Hopper kernels for the stepped TRSM and
SYRK. It imports neither ``jax`` nor ``repro``."""

__all__: list = []
