"""The port's scheduling half on the CPU, mirroring tests/test_scheduler.py.

The copied policies (``repro_torch.serving.sched``) order, pick victims and
pick migration targets exactly as the reference's on the same requests;
the port's engine serves the reference engine's per-request outcomes
(backend, greedy tokens, dropped, preemption count) across the scheduler x
preemption x KV-discipline matrix at fp32 with bridged weights, on a
virtual clock so every deadline decision agrees; and the port alone
shows the contract of each mode: scheduling never changes tokens, a
resume loses and duplicates nothing, drop completes early with partial
output, migrate moves a victim to the cheaper variant, and chunked prefill
lets resident rows decode while a long prompt prefills."""
import numpy as np
import pytest

from _torch_parity import (outcome, port_variants, reference_weights,
                           serve_staggered)
from conftest import MAX_NEW, PROMPT_LEN, VOCAB, tiny_variants
from repro.serving import sched as jsched
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.engine import InProcessServingEngine as PEngine
from repro_torch.serving.sched import (MAX_PREEMPTIONS, ChunkedScheduler,
                                       EDFScheduler, FIFOScheduler,
                                       make_scheduler, migration_target)

GEOMETRY = dict(max_batch=2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                decode_chunk=2, kv_page_size=4, prefill_chunk=4)

_RNG = np.random.default_rng(11)
PROMPTS = [_RNG.integers(0, VOCAB, 8) for _ in range(6)]


def _engine(cls=PEngine, n_variants=1, **kw):
    """An engine on the tiny geometry with a virtual clock (``eng.t``) and
    every variant loaded; the port's runs the reference's weights."""
    jv = tiny_variants(n_variants)
    t = [0.0]
    kw = {**GEOMETRY, **kw}
    kw.setdefault("clock", lambda: t[0])
    if cls is JEngine:
        eng = JEngine(jv, **kw)
    else:
        eng = PEngine(port_variants(jv), device="cpu",
                      weights=reference_weights(jv), **kw)
    eng.t = t
    eng.apply_allocation(0.0, {n: 1 for n in jv})
    return eng


def _req(rid, prompt, slo_ms=0.0, arrival=0.0, max_new=MAX_NEW):
    return PRequest(rid=rid, tokens=prompt, max_new=max_new, arrival=arrival,
                    slo_ms=slo_ms)


# ---------------------------------------------------------------- policies
def test_make_scheduler_specs():
    assert isinstance(make_scheduler("fifo"), FIFOScheduler)
    assert isinstance(make_scheduler("edf"), EDFScheduler)
    ch = make_scheduler("chunked")
    assert isinstance(ch, ChunkedScheduler) and ch.chunked
    assert make_scheduler("chunked-fifo").name == "chunked-fifo"
    assert make_scheduler(ch) is ch          # pass-through
    with pytest.raises(ValueError):
        make_scheduler("lifo")
    for spec in ("fifo", "edf", "chunked", "chunked-fifo"):
        assert make_scheduler(spec).describe() == \
            jsched.make_scheduler(spec).describe()


def _request_pairs(seed, n=12):
    """The same random requests as port and reference objects: deadlines
    around ``now`` = 10 (some already passed), ties in deadline broken by
    priority and arrival, a few preempted to the cap."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = dict(rid=i, tokens=np.zeros(4, np.int64), max_new=4,
                  arrival=float(rng.integers(0, 8)),
                  slo_ms=float(rng.choice([0.0, 1000.0, 4000.0, 9000.0])),
                  priority=float(rng.integers(0, 2)))
        p, j = PRequest(**kw), JRequest(**kw)
        p.preemptions = j.preemptions = int(rng.integers(0, 3))
        out.append((p, j))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("spec", ["fifo", "edf", "chunked", "chunked-fifo"])
def test_order_and_victims_match_reference(spec, seed):
    pairs = _request_pairs(seed)
    ps, js = [p for p, _ in pairs], [j for _, j in pairs]
    pol, ref = make_scheduler(spec), jsched.make_scheduler(spec)
    assert [r.rid for r in pol.order(ps, 10.0)] == \
        [r.rid for r in ref.order(js, 10.0)]
    for free in (0, 1, 3):
        got = pol.select_victims(ps[:6], ps[6:], 10.0, free)
        want = ref.select_victims(js[:6], js[6:], 10.0, free)
        assert [r.rid for r in got] == [r.rid for r in want]


def test_edf_order_feasible_first_then_expired():
    s = EDFScheduler()
    feas_late = _req(0, PROMPTS[0], slo_ms=90_000.0, arrival=5.0)
    feas_soon = _req(1, PROMPTS[1], slo_ms=6_000.0, arrival=9.0)
    expired = _req(2, PROMPTS[2], slo_ms=1_000.0, arrival=1.0)
    ordered = s.order([feas_late, expired, feas_soon], 10.0)
    assert [r.rid for r in ordered] == [1, 0, 2]   # expired sorts last


def test_edf_victims_bounded_and_only_hopeless():
    s = EDFScheduler()
    hopeless = _req(0, PROMPTS[0], slo_ms=1_000.0)
    capped = _req(1, PROMPTS[1], slo_ms=1_000.0)
    capped.preemptions = MAX_PREEMPTIONS
    feasible = _req(2, PROMPTS[2], slo_ms=1e9)
    waiting = [_req(3, PROMPTS[3], slo_ms=1e9, arrival=90.0)]
    victims = s.select_victims([hopeless, capped, feasible], waiting, 100.0,
                               0)
    assert victims == [hopeless]         # not the capped, not the feasible
    assert s.select_victims([hopeless], waiting, 100.0, 1) == []


def test_migration_target_matches_reference():
    class B:
        def __init__(self, acc):
            self.accuracy = acc
    backends = {"a": B(70.0), "b": B(75.0), "c": B(78.0), "d": B(70.0)}
    queues = {"a": [1, 2], "d": [1]}
    for cur in backends:
        assert migration_target(cur, backends, queues) == \
            jsched.migration_target(cur, backends, queues)
    assert migration_target("c", backends, queues) == "d"   # shorter queue
    assert migration_target("a", backends, queues) is None


# ----------------------------------------------------- engine vs reference
CASES = [
    # scheduler, preemption, variants
    ("fifo", "none", 1), ("edf", "none", 1), ("chunked", "none", 1),
    ("chunked-fifo", "none", 1), ("edf", "requeue", 1),
    ("chunked", "requeue", 1), ("edf", "drop", 1), ("chunked", "drop", 1),
    ("chunked", "migrate", 2),
]


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
@pytest.mark.parametrize("scheduler,preemption,n_variants", CASES)
def test_scheduler_preemption_kv_matrix_matches_reference(
        scheduler, preemption, n_variants, kv_cache):
    """The port engine against the reference engine on one staggered
    workload (tight deadlines on even rids when preemption is on, every
    request sent to the most accurate variant): the same per-request
    backend, greedy tokens, drop flag and preemption count."""
    got = {}
    for cls, req in ((JEngine, JRequest), (PEngine, PRequest)):
        eng = _engine(cls, n_variants=n_variants, kv_cache=kv_cache,
                      scheduler=scheduler, preemption=preemption)
        target = "big" if n_variants > 1 else "small"
        got[cls] = outcome(serve_staggered(
            eng, req, tight=preemption != "none", prompt_len=PROMPT_LEN,
            vocab=VOCAB, max_new=MAX_NEW, backend=target))
    assert len(got[PEngine]) == 8
    assert got[PEngine] == got[JEngine]
    if preemption != "none":
        assert any(o[3] for o in got[PEngine].values())   # it fired


# -------------------------------------------------------- the port's modes
@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_schedulers_never_change_tokens(kv_cache):
    """kv x scheduler all serve the FIFO path's greedy tokens."""
    outs = {}
    for spec in ("fifo", "edf", "chunked", "chunked-fifo"):
        eng = _engine(kv_cache=kv_cache, scheduler=spec)
        for i, p in enumerate(PROMPTS):
            assert eng.submit(_req(i, p, slo_ms=100.0 * (i + 1)), "small")
        eng.drain(0.0)
        assert len(eng.done) == len(PROMPTS)
        outs[spec] = {r.rid: list(r.output) for r in eng.done}
    for spec in ("edf", "chunked", "chunked-fifo"):
        assert outs[spec] == outs["fifo"]


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_preemption_resume_never_loses_tokens(kv_cache):
    """Hopeless requests take the slots, feasible ones arrive and preempt
    them: every request's tokens equal the unpressured run's (nothing
    lost, nothing duplicated), preemptions stay bounded and the pool
    never leaks at any tick."""
    ref = _engine(kv_cache=kv_cache, max_new=10)
    for i, p in enumerate(PROMPTS):
        ref.submit(_req(i, p, max_new=10), "small")
    ref.drain(0.0)
    want = {r.rid: list(r.output) for r in ref.done}

    eng = _engine(kv_cache=kv_cache, scheduler="edf", preemption="requeue",
                  max_new=10, clock=lambda: 0.0)
    b = eng.backends["small"]
    rng = np.random.default_rng(13)
    preempted = False
    for _ in range(3):
        eng.done.clear()
        ids = rng.permutation(6)
        for i in ids[:2]:
            assert eng.submit(_req(int(i), PROMPTS[i], slo_ms=1.0,
                                   max_new=10), "small")
        eng.step(100.0)                  # admit the hopeless pair
        for i in ids[2:]:
            assert eng.submit(_req(int(i), PROMPTS[i], slo_ms=1e9,
                                   max_new=10), "small")
        for _ in range(200):
            eng.step(100.0)
            if hasattr(b, "pool"):
                assert b.pool.used_pages == \
                    b.active_slots * b.pages_per_slot
            if len(eng.done) == 6:
                break
        assert sorted(r.rid for r in eng.done) == list(range(6))
        for r in eng.done:
            assert r.preemptions <= MAX_PREEMPTIONS
            preempted |= r.preemptions > 0
            assert list(r.output) == want[r.rid]
        if hasattr(b, "pool"):
            assert b.pool.used_pages == 0
    assert preempted
    assert eng.metrics.value("requests.preempted") > 0


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_preemption_drop_completes_early_with_partial_output(kv_cache):
    eng = _engine(kv_cache=kv_cache, scheduler="edf", preemption="drop",
                  max_new=10, clock=lambda: 0.0)
    eng.submit(_req(0, PROMPTS[0], slo_ms=1.0, max_new=10), "small")
    eng.submit(_req(1, PROMPTS[1], slo_ms=1.0, max_new=10), "small")
    eng.step(100.0)                      # admit both (slots free)
    for i in range(2, 6):
        eng.submit(_req(i, PROMPTS[i], slo_ms=1e9, max_new=10,
                        arrival=100.0), "small")
    for _ in range(100):
        eng.step(100.0)
        if len(eng.done) == 6:
            break
    done = {r.rid: r for r in eng.done}
    dropped = [r for r in eng.done if r.dropped]
    assert dropped and all(r.rid in (0, 1) for r in dropped)
    assert all(len(r.output) < 10 for r in dropped)
    assert all(len(done[i].output) == 10 and not done[i].dropped
               for i in range(2, 6))
    assert eng.metrics.value("requests.dropped") == len(dropped)
    s = eng.summarize(slo_ms=1e12, best_accuracy=70.0)
    assert s["goodput"] < 1.0                # drops can't count as goodput


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_migrate_moves_victims_to_the_cheaper_variant(kv_cache):
    """Victims preempted on "big" resume on "small" (70 < 75 accuracy) with
    their generated tokens kept: each migrated request's output starts with
    what it had generated on "big" and completes its budget."""
    eng = _engine(n_variants=2, kv_cache=kv_cache, scheduler="edf",
                  preemption="migrate", max_new=10, clock=lambda: 0.0)
    eng.submit(_req(0, PROMPTS[0], slo_ms=1.0, max_new=10), "big")
    eng.submit(_req(1, PROMPTS[1], slo_ms=1.0, max_new=10), "big")
    eng.step(100.0)
    eng.step(100.0)                      # both decode a chunk on "big"
    gen = {r.rid: list(eng.backends["big"].slot_tokens[s])
           for s, r in enumerate(eng.backends["big"].slot_req) if r}
    for i in range(2, 5):
        eng.submit(_req(i, PROMPTS[i], slo_ms=1e9, max_new=10,
                        arrival=100.0), "big")
    eng.drain(100.0)
    done = {r.rid: r for r in eng.done}
    assert sorted(done) == list(range(5))
    moved = [r for r in eng.done if r.backend == "small"]
    assert moved and {r.rid for r in moved} <= {0, 1}
    for r in moved:
        assert len(r.output) == 10 and not r.dropped
        assert list(r.output[:len(gen[r.rid])]) == gen[r.rid]
    assert eng.metrics.value("requests.migrated") == len(moved)


def test_edf_admits_tight_deadline_first():
    eng = _engine(scheduler="edf", clock=lambda: 50.0)
    for i in range(4):
        eng.submit(_req(i, PROMPTS[i], slo_ms=1e6, arrival=float(i)),
                   "small")
    eng.submit(_req(9, PROMPTS[4], slo_ms=60_000.0, arrival=4.0), "small")
    eng.step(50.0)                       # admits 2 of 5 queued
    admitted = {r.rid for r in eng.backends["small"].slot_req
                if r is not None} | {r.rid for r in eng.done}
    assert 9 in admitted


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_chunked_interleaves_decode_with_long_prefill(kv_cache):
    """While a long prompt prefills chunk by chunk, the resident sequence
    keeps emitting a token every tick, and a prompt is right-sized: a
    12-token prompt costs three 4-token chunks, not a padded 32."""
    eng = _engine(kv_cache=kv_cache, scheduler="chunked", prompt_len=32,
                  prefill_chunk=4, max_new=24, decode_chunk=1)
    b = eng.backends["small"]
    rng = np.random.default_rng(3)
    eng.submit(_req(0, rng.integers(0, VOCAB, 12), max_new=24), "small")
    for _ in range(3):
        eng.step(0.0)
    assert b.prefill_tokens_total == 12 and not b._prefilling
    eng.submit(_req(1, rng.integers(0, VOCAB, 32), max_new=24), "small")
    grown = []
    for _ in range(10):
        before = len(b.slot_tokens[0])
        was = bool(b._prefilling) or not grown
        eng.step(0.0)
        if was and b._prefilling:
            grown.append(len(b.slot_tokens[0]) > before)
    assert grown and all(grown)          # decode progressed during prefill
    eng.drain(0.0)
    assert len(eng.done) == 2
    assert all(len(r.output) == 24 for r in eng.done)
