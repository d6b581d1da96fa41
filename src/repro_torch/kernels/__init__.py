"""Kernels of the port: three CUDA kernels for Hopper (``csrc/``), each
with a plain PyTorch version beside it, behind the device-dispatched
entry points of `repro_torch.kernels.ops`."""
