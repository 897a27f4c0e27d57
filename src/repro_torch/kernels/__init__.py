"""Attention and SSD-scan kernels: CUDA C++ for Hopper (``csrc/``), built at first use
(``build``), each beside its plain PyTorch version; ``ops`` holds the
public layouts and the launch counters."""
