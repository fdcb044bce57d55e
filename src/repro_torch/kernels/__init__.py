"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions (``megabatch.py``) and the routing wrappers (``ops.py``)."""
