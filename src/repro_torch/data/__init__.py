"""Workload and training data of the port: the synthetic, seeded
request-rate traces (``traces``, a copy of the reference's host-only
module) and the synthetic token pipeline for LM training (``tokens``)."""
