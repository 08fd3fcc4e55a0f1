"""Kernels of the port: CUDA C++ under ``csrc/`` with their plain versions.

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises.  Every wrapper counts
its launches (``wrapper.launches``) and every plain version its calls
(``plain.calls``); `repro_torch.kernels.ops.KERNELS` lists them all.
"""
