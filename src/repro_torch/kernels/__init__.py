"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the executor-facing entry points (``ops``)."""
