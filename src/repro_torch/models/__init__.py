"""Dense language model of the port: layers, attention and ``LM``."""
