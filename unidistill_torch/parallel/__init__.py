"""Data parallelism and BEV spatial sharding over ranks; the port's
counterpart of the JAX package's `parallel/` (`mesh.py`, `spatial.py`)."""
