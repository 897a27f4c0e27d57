"""Step capture on the CPU: the engines' static-buffer path (``StepGraph``
running each step eagerly on its static buffers, the default) against the
direct eager path (``step_graphs=False``), bitwise on per-request outputs
and on every cache leaf, for the dense engine, the paged engine with
prefix sharing on and off, and the mamba2 smoke ladder; and the refusals:
a replaced captured tensor, a shape the step was not built for, a step
shape with no graph. The replays themselves run only on a card
(``tests/test_torch_cuda.py``)."""
import time

import numpy as np
import pytest
import torch
from conftest import MAX_NEW, PROMPT_LEN, VOCAB, tiny_variants

from _torch_parity import port_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_ladder
from repro_torch.serving.api import Request
from repro_torch.serving.engine import InProcessServingEngine, VariantBackend
from repro_torch.serving.graphs import StepGraph, StepGraphError

GEOMETRY = dict(max_batch=2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                decode_chunk=2)


def _port_variants(n):
    return {k: (port_config(c), a) for k, (c, a) in tiny_variants(n).items()}


def _requests(n, seed, vocab=VOCAB, prompt_len=PROMPT_LEN):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, prompt_len + 1, n)
    budgets = rng.integers(1, MAX_NEW + 3, n)        # 1 finishes at admit
    return [Request(rid=i, tokens=rng.integers(0, vocab, int(lens[i])),
                    max_new=int(budgets[i]), arrival=time.time())
            for i in range(n)]


def _state(eng):
    """Every backend's resident cache leaves and current tokens."""
    return {n: {**{k: t.clone() for k, t in b.cache.items()},
                "cur_tok": b.cur_tok.clone()}
            for n, b in eng.backends.items()}


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert a[n].keys() == b[n].keys()
        for k in a[n]:
            assert torch.equal(a[n][k], b[n][k]), (n, k)


def _serve(variants, step_graphs, reqs, mode="continuous", **geo):
    eng = InProcessServingEngine(variants, device="cpu", mode=mode,
                                 step_graphs=step_graphs, **geo)
    names = list(variants)
    eng.apply_allocation(0.0, {n: 1 for n in names})
    for r in reqs:
        assert eng.submit(r, names[r.rid % len(names)])
    eng.drain(0.0) if mode == "continuous" else eng.pump(0.0)
    return {r.rid: (r.backend, list(r.output)) for r in eng.done}, eng


@pytest.mark.parametrize("mode", ["continuous", "pump"])
def test_dense_engine_static_buffers_equal_direct(mode):
    pv = _port_variants(2)
    got, eng = _serve(pv, True, _requests(9, 5), mode, **GEOMETRY)
    want, ref = _serve(pv, False, _requests(9, 5), mode, **GEOMETRY)
    assert len(want) == 9 and got == want
    _assert_same_state(_state(eng), _state(ref))
    assert all(b.graphs for b in eng.backends.values())
    assert not any(b.graphs for b in ref.backends.values())


def _shared_prompts():
    """Five 16-token prompts over one 8-token prefix, three identical (the
    copy-on-write boundary)."""
    rng = np.random.default_rng(9)
    pre = rng.integers(0, VOCAB, 8)
    p0 = np.concatenate([pre, rng.integers(0, VOCAB, 8)])
    return [p0, np.concatenate([pre, rng.integers(0, VOCAB, 8)]), p0,
            np.concatenate([pre, rng.integers(0, VOCAB, 8)]), p0]


def _serve_paged(step_graphs, sharing):
    eng = InProcessServingEngine(
        _port_variants(1), device="cpu", max_batch=3, prompt_len=16,
        max_new=6, decode_chunk=2, kv_cache="paged", kv_page_size=4,
        kv_prefix_sharing=sharing, prefill_chunk=4, step_graphs=step_graphs)
    eng.apply_allocation(0.0, {"small": 1})
    for i, p in enumerate(_shared_prompts()):   # staggered: fused ticks
        eng.submit(Request(rid=i, tokens=p, max_new=6, arrival=time.time()),
                   "small")
        eng.step(0.0)
    eng.drain(0.0)
    return {r.rid: list(r.output) for r in eng.done}, eng


@pytest.mark.parametrize("sharing", [False, True])
def test_paged_engine_static_buffers_equal_direct(sharing):
    got, eng = _serve_paged(True, sharing)
    want, ref = _serve_paged(False, sharing)
    assert len(want) == 5 and got == want
    _assert_same_state(_state(eng), _state(ref))
    b, rb = eng.backends["small"], ref.backends["small"]
    assert b.prefill_tokens_total == rb.prefill_tokens_total
    assert (b.pool.prefix_hits > 0) == sharing
    steps = {name for name, _ in b.graphs}
    assert steps == ({"prefill", "chunk", "fused"} if sharing
                     else {"prefill", "chunk"})


@pytest.mark.parametrize("mode", ["continuous", "pump"])
def test_mamba2_ladder_static_buffers_equal_direct(mode):
    ladder = build_ladder("mamba2-130m")
    pv = {n: ladder[n] for n in list(ladder)[:2]}           # depths 2 and 4
    vocab = next(iter(pv.values()))[0].vocab_size
    geo = dict(GEOMETRY, prompt_len=16)
    got, eng = _serve(pv, True, _requests(7, 1, vocab, 16), mode, **geo)
    want, ref = _serve(pv, False, _requests(7, 1, vocab, 16), mode, **geo)
    assert len(want) == 7 and got == want
    _assert_same_state(_state(eng), _state(ref))


def test_pending_tokens_are_copies_of_the_step_buffers():
    """A pending record's tokens never change when a later step runs."""
    cfg, acc = _port_variants(1)["small"]
    b = VariantBackend("small", cfg, acc, device="cpu", **GEOMETRY)
    b.admit(_requests(2, 3)[:1], 0.0)
    toks = b._step("chunk", None)
    pend = b.dispatch_decode(0.0)
    held = pend.toks.clone()
    b._step("chunk", None)
    assert torch.equal(pend.toks, held)
    assert pend.toks.data_ptr() != toks.data_ptr()


def _cache_graph():
    cache = {"x": torch.zeros(3), "n": torch.zeros((), dtype=torch.int64)}

    def step(inc):
        cache["x"].add_(inc)
        cache["n"].add_(1)
        return cache["x"] * 2

    g = StepGraph("toy", step, {"inc": torch.ones(3)},
                  lambda: list(cache.values()))
    g.capture()
    return g, cache


def test_step_graph_runs_on_its_static_buffers():
    g, cache = _cache_graph()
    x = torch.tensor([1.0, 2.0, 3.0])
    out = g.run(inc=x)
    assert torch.equal(g.static["inc"], x) and g.static["inc"] is not x
    # warm-up ran the step once, on the example input of ones
    assert torch.equal(cache["x"], torch.tensor([2.0, 3.0, 4.0]))
    assert torch.equal(out, 2 * cache["x"]) and int(cache["n"]) == 2


def test_step_graph_raises_when_a_captured_tensor_is_replaced():
    g, cache = _cache_graph()
    cache["x"].mul_(0)                         # in place: fine
    g.run(inc=torch.ones(3))
    cache["x"] = torch.zeros(3)                # replaced: the graph would
    with pytest.raises(StepGraphError, match="replaced"):   # read stale
        g.run(inc=torch.ones(3))


@pytest.mark.parametrize("inputs", [
    {"inc": torch.ones(4)}, {"inc": torch.ones((3, 1))},
    {"inc": torch.ones(3, dtype=torch.float64)},
    {"inc": torch.ones(3), "other": torch.ones(3)}, {}])
def test_step_graph_raises_on_inputs_it_was_not_built_for(inputs):
    g, cache = _cache_graph()
    before = cache["x"].clone()
    with pytest.raises(StepGraphError):
        g.run(**inputs)
    assert torch.equal(cache["x"], before)     # nothing ran


def test_step_graph_raises_before_capture():
    g = StepGraph("toy", lambda a: a + 1, {"a": torch.zeros(2)}, lambda: [])
    with pytest.raises(StepGraphError, match="never captured"):
        g.run(a=torch.zeros(2))


@pytest.mark.parametrize("step_graphs", [True, False])
def test_a_step_shape_with_no_graph_raises(step_graphs):
    cfg, acc = _port_variants(1)["small"]
    b = VariantBackend("small", cfg, acc, device="cpu",
                       step_graphs=step_graphs, **GEOMETRY)
    if step_graphs:        # the direct path runs any prompt length
        with pytest.raises(StepGraphError):    # pump prompts of another length
            b.generate(np.zeros((2, PROMPT_LEN + 1), np.int64), 2)
    with pytest.raises(StepGraphError):        # a batch the dense prefill
        b._step("prefill", 1, tokens=torch.zeros((1, PROMPT_LEN),  # lacks
                                                 dtype=torch.int64))
    with pytest.raises(StepGraphError):        # no fused tick: not chunked
        b._prefill_chunk_step(*(np.zeros((2, 16), np.int64),)
                              + (np.zeros(2, np.int64),) * 2
                              + (np.zeros(2, bool),) * 2)


def test_retiring_a_variant_drops_its_graphs():
    eng = InProcessServingEngine(_port_variants(2), device="cpu", **GEOMETRY)
    eng.apply_allocation(0.0, {"small": 1, "big": 1})
    b = eng.backends["big"]
    assert set(b.graphs) == {("prefill", 2), ("decode", 2), ("chunk", None)}
    eng.apply_allocation(0.0, {"small": 1})
    assert "big" not in eng.backends and not b.graphs and not b._steps


def test_add_launch_counts_adds_per_kernel():
    """What a replay and a capture's take-back use on the counters."""
    before = ops.launch_counts()
    ops.add_launch_counts({"flash_decode": 3, "ssd_scan": 1})
    after = ops.launch_counts()
    assert after["flash_decode"] == before["flash_decode"] + 3
    assert after["ssd_scan"] == before["ssd_scan"] + 1
    ops.add_launch_counts({"flash_decode": -3, "ssd_scan": -1})
    assert ops.launch_counts() == before
