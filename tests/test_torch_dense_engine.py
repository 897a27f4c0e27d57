"""The gemma-2b smoke ladder (2/4/6 layers at d_model 128: MQA, GeGLU,
the tied embedding, gemma's embedding scale) through the port's engine and
the reference's, on one staggered workload under a virtual clock, the port
running the reference backends' own weights: dense FIFO, paged with prefix
sharing, and dense ``chunked`` scheduling. Every request lands on the same
rung with the same greedy tokens, and the summaries are equal."""
import numpy as np
import pytest

from _torch_parity import (outcome, port_variants, reference_weights,
                           serve_staggered)
from repro.launch.serve import build_ladder as jladder
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.engine import InProcessServingEngine as PEngine

GEOMETRY = dict(max_batch=2, prompt_len=8, max_new=6, decode_chunk=2,
                kv_page_size=4, prefill_chunk=4)
VOCAB = 512                         # the smoke variant's vocabulary


def _engine(cls, jv, alloc=None, **kw):
    t = [0.0]
    kw = {**GEOMETRY, **kw, "clock": lambda: t[0]}
    if cls is JEngine:
        eng = JEngine(jv, **kw)
    else:
        eng = PEngine(port_variants(jv), device="cpu",
                      weights=reference_weights(jv), **kw)
    eng.t = t
    eng.apply_allocation(0.0, alloc or {n: 1 for n in jv})
    return eng


@pytest.mark.parametrize("label,kw,sharing", [
    ("dense-fifo", {}, False),
    ("paged-sharing", dict(kv_cache="paged", kv_prefix_sharing=True), True),
    ("dense-chunked", dict(scheduler="chunked"), False)])
def test_gemma_smoke_ladder_matches_reference_engine(label, kw, sharing):
    jv = jladder("gemma-2b")
    assert [n for n in jv] == ["gemma-2b-L2", "gemma-2b-L4", "gemma-2b-L6"]
    c = jv["gemma-2b-L2"][0]
    assert (c.num_kv_heads, c.mlp_type, c.tie_embeddings) == (1, "geglu",
                                                              True)
    got, summary = {}, {}
    for cls, req in ((JEngine, JRequest), (PEngine, PRequest)):
        eng = _engine(cls, jv, **kw)
        got[cls] = outcome(serve_staggered(
            eng, req, n=9, sharing=sharing, prompt_len=8, vocab=VOCAB,
            max_new=6))
        summary[cls] = eng.summarize(5000.0, 78.0)
        if sharing:
            summary[cls]["kv"] = eng.kv_pool_stats()
    assert len(got[PEngine]) == 9
    assert len({b for b, *_ in got[PEngine].values()}) > 1   # rungs mixed
    assert got[PEngine] == got[JEngine]
    assert summary[PEngine] == summary[JEngine]
    if sharing:
        assert summary[PEngine]["kv"]["prefix_hits"] > 0
    assert np.isfinite(summary[PEngine]["p99_ms"])


SPEC_COUNTERS = ("spec.batch_rounds", "spec.rounds", "spec.committed_tokens",
                 "spec.drafts_accepted", "spec.drafts_proposed")


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_gemma_speculative_matches_reference_engine(kv_cache):
    jv = jladder("gemma-2b")
    target = "gemma-2b-L4"
    got, counters = {}, {}
    for cls, req in ((JEngine, JRequest), (PEngine, PRequest)):
        eng = _engine(cls, jv, alloc={target: 1}, kv_cache=kv_cache,
                      speculative=f"gemma-2b-L2:{target}", spec_k=2)
        got[cls] = outcome(serve_staggered(
            eng, req, n=6, prompt_len=8, vocab=VOCAB, max_new=6,
            backend=target))
        counters[cls] = {k: eng.metrics.value(k) for k in SPEC_COUNTERS}
    assert len(got[PEngine]) == 6
    assert got[PEngine] == got[JEngine]
    assert counters[PEngine] == counters[JEngine]
    assert counters[PEngine]["spec.rounds"] > 0
