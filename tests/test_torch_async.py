"""The port's async dispatch/commit tick on the CPU, mirroring
tests/test_async_engine.py.

With ``async_tick=True`` the engine dispatches tick t's step and only then
commits tick t-1's tokens. What is held here: inside the port, async
outputs are bitwise the sync tick's across the KV-discipline x scheduler x
preemption matrix, and equal to the reference engine's (bridged weights,
fp32, a virtual clock so deadline decisions agree); a pending exec lives
between ticks and ``flush_pending`` commits it; a zombie slot (finished by
count, not yet committed) holds admission back one tick only; nothing
leaks after a drain; async needs continuous mode; SSM variants stay
monolithic and pipeline their decode chunks only."""
import numpy as np
import pytest

from _torch_parity import (outcome, port_config, port_variants,
                           reference_weights, serve_staggered)
from conftest import MAX_NEW, PROMPT_LEN, VOCAB, tiny_variants
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.engine import InProcessServingEngine as PEngine

GEOMETRY = dict(max_batch=2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                decode_chunk=2, kv_page_size=4)


def _engine(cls, **kw):
    """An engine of ``cls`` on the tiny geometry with a virtual clock
    (``eng.t``), the "small" variant loaded."""
    jv = tiny_variants(1)
    t = [0.0]
    kw = {**GEOMETRY, **kw}
    if cls is JEngine:
        eng = JEngine(jv, clock=lambda: t[0], **kw)
    else:
        eng = PEngine(port_variants(jv), device="cpu",
                      weights=reference_weights(jv), clock=lambda: t[0],
                      **kw)
    eng.t = t
    eng.apply_allocation(0.0, {"small": 1})
    return eng


def _assert_clean(eng):
    """Post-drain invariants: the pipeline left nothing behind."""
    for b in eng.backends.values():
        assert b._pending is None, "un-committed exec after drain"
        assert not b._uncommitted_done, "zombie slots after drain"
        assert all(r is None for r in b.slot_req), "bound slot after drain"
        pool = getattr(b, "pool", None)
        if pool is not None:
            pool.assert_invariants()
            assert pool.used_pages == 0, "leaked pool pages after drain"


MATRIX = [
    # kv_cache, sharing, scheduler, preemption
    ("dense", False, "fifo", "none"),
    ("paged", False, "fifo", "none"),
    ("paged", True, "fifo", "none"),
    ("dense", False, "chunked", "none"),
    ("paged", False, "chunked", "none"),
    ("paged", True, "chunked", "none"),
    ("dense", False, "chunked", "requeue"),
    ("paged", True, "chunked", "requeue"),
]


@pytest.mark.parametrize("kv_cache,sharing,scheduler,preemption", MATRIX)
def test_async_greedy_parity(kv_cache, sharing, scheduler, preemption):
    """Port sync == port async bitwise (outputs and the done-set), and both
    equal the reference engine's sync outputs."""
    kw = dict(kv_cache=kv_cache, scheduler=scheduler, preemption=preemption)
    if sharing:
        kw["kv_prefix_sharing"] = True
    load = dict(sharing=sharing, tight=preemption != "none",
                prompt_len=PROMPT_LEN, vocab=VOCAB, max_new=MAX_NEW)
    outs = {}
    for name, cls, req, async_tick in (("ref", JEngine, JRequest, False),
                                       ("sync", PEngine, PRequest, False),
                                       ("async", PEngine, PRequest, True)):
        eng = _engine(cls, async_tick=async_tick, **kw)
        outs[name] = {rid: o[1] for rid, o in
                      outcome(serve_staggered(eng, req, **load)).items()}
        if cls is PEngine:
            _assert_clean(eng)
    assert len(outs["sync"]) == 8
    assert outs["async"] == outs["sync"]
    assert outs["sync"] == outs["ref"]


def test_async_requires_continuous_mode():
    with pytest.raises(ValueError):
        PEngine(port_variants(tiny_variants(1)), device="cpu", mode="pump",
                async_tick=True, **GEOMETRY)


def test_pending_exec_lives_between_ticks_and_flush_commits():
    prompt = np.random.default_rng(3).integers(0, VOCAB, PROMPT_LEN)

    def serve_one(async_tick, probe=False):
        eng = _engine(PEngine, async_tick=async_tick)
        t, b = eng.t, eng.backends["small"]
        eng.submit(PRequest(rid=0, tokens=prompt.copy(), max_new=MAX_NEW,
                            arrival=0.0), None)
        eng.step(t[0])        # admit + dispatch (nothing to commit)
        if probe:
            assert b._pending is not None, \
                "no in-flight exec after an active tick"
            assert b.chunked           # async admits through the fused tick
            # commit on demand (shutdown path); flushing mid-run must not
            # disturb the token stream
            assert eng.flush_pending(t[0]) == 0
            assert b._pending is None
            assert b.commit_wait_ms >= 0.0 and b.commit_gap_ms >= 0.0
        t[0] += 0.05
        for _ in range(200):
            if not eng.backlog(t[0]) and not eng.in_flight():
                break
            eng.step(t[0])
            t[0] += 0.05
        _assert_clean(eng)
        return list(eng.done[0].output)

    assert serve_one(True, probe=True) == serve_one(False)


def test_zombie_slot_blocks_admission_for_one_tick_only():
    """A request finished by count at dispatch holds its slot until the
    commit one tick later: admission headroom lags exactly one tick, and
    the waiter still completes."""
    eng = _engine(PEngine, async_tick=True, max_batch=1)
    t, b = eng.t, eng.backends["small"]
    rng = np.random.default_rng(5)
    for i in range(2):                   # 1 slot, 2 requests: queueing
        eng.submit(PRequest(rid=i, tokens=rng.integers(0, VOCAB, PROMPT_LEN),
                            max_new=2, arrival=0.0), None)
    zombie_ticks = 0
    for _ in range(200):
        if not eng.backlog(t[0]) and not eng.in_flight():
            break
        had_zombie = bool(b._uncommitted_done)
        eng.step(t[0])
        if had_zombie:
            zombie_ticks += 1
            assert not b._uncommitted_done or b.slot_req[0].rid == 1
        t[0] += 0.05
    _assert_clean(eng)
    assert zombie_ticks >= 1
    assert sorted(r.rid for r in eng.done) == [0, 1]
    assert all(len(r.output) == 2 for r in eng.done)


def test_dispatch_decode_is_none_when_only_zombies_remain():
    eng = _engine(PEngine, async_tick=True)
    b = eng.backends["small"]
    eng.submit(PRequest(rid=0, tokens=np.arange(PROMPT_LEN), max_new=3,
                        arrival=0.0), None)
    t = eng.t
    while not b._uncommitted_done:
        eng.step(t[0])
        t[0] += 0.05
    assert b.active_slots == 1 and not b._prefilling
    assert b.dispatch_decode(t[0]) is None   # the only row is a zombie
    eng.drain(t[0])
    _assert_clean(eng)
    assert len(eng.done) == 1 and len(eng.done[0].output) == 3


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_schedules_complete_without_leaks(seed):
    """Arbitrary arrival gaps and budgets on the async paged chunked engine
    with sharing: every request completes with its budget and no slot, page
    or pending exec is left."""
    eng = _engine(PEngine, async_tick=True, kv_cache="paged",
                  kv_prefix_sharing=True, scheduler="chunked")
    t = eng.t
    rng = np.random.default_rng(seed)
    base = rng.integers(0, VOCAB, PROMPT_LEN)
    n = 10
    for i in range(n):
        toks = base.copy() if i % 3 == 0 else rng.integers(0, VOCAB,
                                                           PROMPT_LEN)
        eng.submit(PRequest(rid=i, tokens=toks,
                            max_new=int(rng.integers(1, MAX_NEW + 1)),
                            arrival=t[0]), None)
        for _ in range(int(rng.integers(0, 3))):
            eng.step(t[0])
            t[0] += 0.05
    eng.drain(t[0])
    _assert_clean(eng)
    assert sorted(r.rid for r in eng.done) == list(range(n))
    for r in eng.done:
        assert len(r.output) == min(r.max_new, MAX_NEW)
        assert r.completion >= r.service_start >= r.arrival


def test_ssm_variant_stays_monolithic_under_async():
    """A Mamba-2 smoke variant has no prefill continuation: the async
    engine leaves it unchunked (admission stays monolithic) and pipelines
    its decode chunks; outputs equal the sync tick's."""
    from repro.configs import get_config, smoke_variant
    jc = smoke_variant(get_config("mamba2-130m")).replace(
        num_layers=2, vocab_size=VOCAB)
    variants = {"ssm": (port_config(jc), 70.0)}
    outs = []
    for async_tick in (False, True):
        t = [0.0]
        eng = PEngine(variants, device="cpu", async_tick=async_tick,
                      clock=lambda: t[0], **GEOMETRY)
        eng.t = t
        eng.apply_allocation(0.0, {"ssm": 1})
        assert not eng.backends["ssm"].chunked
        outs.append(outcome(serve_staggered(eng, PRequest, n=5,
                                            prompt_len=PROMPT_LEN,
                                            vocab=VOCAB, max_new=MAX_NEW)))
        _assert_clean(eng)
    assert outs[0] == outs[1] and len(outs[0]) == 5
