"""Kernels of the port: hand-written CUDA sources, launchers, plain versions."""
