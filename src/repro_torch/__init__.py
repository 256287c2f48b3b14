"""PyTorch/CUDA port of the ECI-Cache reproduction (``repro``).

Same layout and names as the JAX package; every entry point runs on the
CUDA card unless the caller asks for the CPU (``device="cpu"``).  Kernels
are hand-written for Hopper (``repro_torch.kernels``).
"""
