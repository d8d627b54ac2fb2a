"""Data parallelism over ranks; the port's counterpart of the JAX package's
`parallel/` (its `mesh.py`; the (dp, bev) spatial mesh is not ported)."""
