"""Language models on PyTorch: configs, layers, attention, Mamba-2 and the
model-level serving functions for the dense, SSM and hybrid families."""
