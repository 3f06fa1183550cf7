"""Tensor ops of the port: masks, attention, int8 quantisation, precision
policy, and the CUDA kernels (``ops.cuda``)."""
