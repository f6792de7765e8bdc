"""The plain reference that decides `correct`: numpy and PyTorch only.  It
imports nothing of the program, of `jax` or of the JAX package, and takes
nothing the program made (`portbench/tests/test_portbench_isolation.py`)."""
