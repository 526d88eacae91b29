"""The benchmark of the PyTorch and CUDA port (``mgroms_tpu_torch``) on one
NVIDIA H100: ``python3 -m portbench.run`` (run.py).  It imports nothing of
JAX or of the JAX package, and of the port only its public entry."""
