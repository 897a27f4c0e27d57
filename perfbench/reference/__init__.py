"""The plain reference: float32, TF32 off, no kernel, no cache, no
batching beyond what the program's own calls share. It imports nothing of
the program (``repro_torch``) and neither JAX nor the JAX package."""
