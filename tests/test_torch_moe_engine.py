"""The granite-moe-3b-a800m smoke ladder (2/4/6 layers at d_model 128:
4 experts, top 2) through the port's engine and the reference's, on one
staggered workload under a virtual clock, the port running the reference
backends' own weights: dense FIFO, paged with prefix sharing, dense
``chunked``, and speculative dense and paged. Every request lands on the
same rung with the same greedy tokens, and the summaries (and the
speculative counters) are equal. Model-level cases are in
``test_torch_moe_model.py``."""
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
SPEC_COUNTERS = ("spec.batch_rounds", "spec.rounds", "spec.committed_tokens",
                 "spec.drafts_accepted", "spec.drafts_proposed")


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
def test_granite_smoke_ladder_matches_reference_engine(label, kw, sharing):
    jv = jladder("granite-moe-3b-a800m")
    assert list(jv) == [f"granite-moe-3b-a800m-L{d}" for d in (2, 4, 6)]
    c = jv["granite-moe-3b-a800m-L2"][0]
    assert (c.family, c.num_experts, c.experts_per_token) == ("moe", 4, 2)
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


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_granite_speculative_matches_reference_engine(kv_cache):
    jv = jladder("granite-moe-3b-a800m")
    target = "granite-moe-3b-a800m-L4"
    got, counters = {}, {}
    for cls, req in ((JEngine, JRequest), (PEngine, PRequest)):
        eng = _engine(cls, jv, alloc={target: 1}, kv_cache=kv_cache,
                      speculative=f"granite-moe-3b-a800m-L2:{target}",
                      spec_k=2)
        got[cls] = outcome(serve_staggered(
            eng, req, n=6, prompt_len=8, vocab=VOCAB, max_new=6,
            backend=target))
        counters[cls] = {k: eng.metrics.value(k) for k in SPEC_COUNTERS}
    assert len(got[PEngine]) == 6
    assert got[PEngine] == got[JEngine]
    assert counters[PEngine] == counters[JEngine]
    assert counters[PEngine]["spec.rounds"] > 0


# ---------------------------------------- retired backends free their memory
@pytest.mark.parametrize("kv", [{}, dict(kv_cache="paged",
                                         kv_prefix_sharing=True)],
                         ids=["dense", "paged"])
def test_retired_backends_leave_no_weight_alive(kv):
    """After ``apply_allocation(t, {})`` and a collection, no tensor of a
    retired backend is alive: its stacked layer weights, its embedding and
    its cache (the backends draw their own weights here, so the engine
    holds none of them)."""
    import gc
    import weakref
    from repro_torch.launch.serve import build_ladder as pladder
    v = pladder("granite-moe-3b-a800m")
    t = [0.0]
    eng = PEngine(v, device="cpu", clock=lambda: t[0], **GEOMETRY, **kv)
    eng.t = t
    eng.apply_allocation(0.0, {n: 1 for n in v})
    refs = [weakref.ref(x) for b in eng.backends.values()
            for x in (b.params["layers"]["ffn"]["wi"],
                      b.params["embed"]["table"],
                      b.cache["kp" if kv else "k"])]
    serve_staggered(eng, PRequest, n=6, prompt_len=8, vocab=VOCAB,
                    max_new=6)
    eng.apply_allocation(t[0], {})
    gc.collect()
    assert not eng.backends and len(eng.done) == 6
    assert [r() for r in refs] == [None] * len(refs)


def test_build_model_keeps_no_params_alive():
    """``build_model`` caches no model process-wide: the per-layer views an
    ``LM`` keeps of the last params it ran go with the model."""
    import gc
    import weakref
    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import build_model
    cfg = smoke_variant(get_config("granite-moe-3b-a800m"))
    lm = build_model(cfg)
    assert build_model(cfg) is not lm
    params = lm.init(torch.Generator().manual_seed(0))
    lm.apply(params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    ref = weakref.ref(params["layers"]["ffn"]["wo"])
    del lm, params
    gc.collect()
    assert ref() is None
