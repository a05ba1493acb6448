"""Apache VXQuery on PyTorch and CUDA: the port of the ``repro`` JAX
package to one NVIDIA GPU. Same layout and the same query semantics;
the Pallas TPU kernels become hand-written CUDA kernels
(``repro_torch.kernels``), each beside a plain PyTorch version."""
