"""Serving layer: the shared ``ClusterAPI``/``ServingAPI`` protocols and
schedulers (host-only), the continuous-batching engine and the wall-clock
serving loop. Only the protocol module is imported eagerly — the engine
pulls in torch."""
from repro_torch.serving.api import (ClusterAPI, Request,  # noqa: F401
                                     ServingAPI, summarize_requests)
from repro_torch.serving.sched import make_scheduler  # noqa: F401
