"""PyTorch/CUDA port of the InfAdapter reproduction.

A second package beside the JAX reference ``repro``: the same serving
system (controller, solver, continuous-batching engine, dense LM) on
PyTorch, with attention on hand-written CUDA kernels for Hopper
(``repro_torch.kernels``). It imports ``torch`` and ``numpy`` and never the
reference package: host-only modules it needs are kept here as copies.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
