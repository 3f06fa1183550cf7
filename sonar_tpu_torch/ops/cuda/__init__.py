"""Hand-written Hopper kernels of the port, one module per TPU kernel of
``sonar_tpu/ops/pallas/``.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter ``LAUNCHES``. The wrapper runs the plain version for a CPU
tensor only; for a CUDA tensor it launches the kernel (built from
``sonar_tpu_torch/csrc/`` at first use) or raises.
"""
