"""PyTorch/CUDA port of the distributed-FMM reproduction.

The JAX package `repro` is the reference; this package mirrors its module
names (`repro_torch.core.api`, `repro_torch.core.engine`, ...) and imports
neither `jax` nor `repro`.  Entry points run on the CUDA device unless the
caller passes `device="cpu"`.

Main path: `core.api.FMMSession.from_points(x, q, spec).evaluate()`.
"""
