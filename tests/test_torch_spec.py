"""Speculative decoding in the port on the CPU, mirroring
tests/test_spec_decode.py.

``LM.verify_chunk`` and ``verify_chunk_paged`` are held to the reference's
at fp32 with bridged weights (argmax equal at every valid position, every
cache leaf within 1e-5, the tolerance of test_torch_chunk_dense.py: both
sides accumulate in fp32, in different orders) and to teacher forcing
through the port's own ``LM.apply``. The port's engine with
``speculative="small:big"`` serves the reference engine's target-only
greedy tokens across the reference's 12-combination matrix (KV discipline
and sharing x scheduler x tick), with the reference speculative engine's
``spec.*`` counters and ``acceptance_stats()``; a drafter with the
verifier's weights accepts every draft; speculative decoding under the
chunked scheduler with requeue preemption gives the reference engine's
per-request outcomes; the static-buffer path (``StepGraph`` on the CPU)
equals ``step_graphs=False`` bitwise in tokens and every cache leaf of
verifier and drafter; a drain owes no request a token; and the engine
refuses what the reference refuses."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (bridged_params, outcome, port_config,
                           port_variants, reference_weights, serve_staggered,
                           to_np)
from conftest import MAX_NEW, PROMPT_LEN, VOCAB, tiny_variants
from repro.models.model import build_model
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.models.model import LM
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.engine import InProcessServingEngine as PEngine

N_REQ = 5
SPEC_K = 2


# ------------------------------------------------------------ verify_chunk
def _verify_case(paged, kernels):
    """Both models on the tiny config with bridged weights, a prompt of 8
    prefilled into a dense cache of 16 or scattered into pages of 4, and
    one verify chunk of 4 at ragged offsets: row 0 right after its prompt,
    row 1 rewound to position 5 (as after a rejected draft), row 2 inert.
    Returns (reference argmax, port argmax, reference cache, port cache,
    cache before, start, n_valid)."""
    jcfg = tiny_variants(1)["small"][0].replace(use_pallas=kernels)
    jp, pp = bridged_params(jcfg)
    jm, pm = build_model(jcfg), LM(port_config(jcfg))
    rng = np.random.default_rng(3)
    B, S0, C, ps, ck = 3, 8, 16, 4, 4
    prompts = rng.integers(0, VOCAB, (B, S0))
    if paged:
        pages = C // ps
        P = B * pages + 1
        page_ids = 1 + rng.permutation(B * pages).reshape(B, pages)
        _, jpre = jax.jit(jm.prefill, static_argnames="max_len")(
            jp, {"tokens": jnp.asarray(prompts, jnp.int32)}, max_len=S0)
        jc, _ = jax.jit(jm.paged_admit)(
            jm.init_paged_cache(B, P, ps, pages), jpre,
            jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
            jnp.asarray(page_ids, jnp.int32), jnp.arange(B, dtype=jnp.int32))
    else:
        _, jc = jax.jit(jm.prefill, static_argnames="max_len")(
            jp, {"tokens": jnp.asarray(prompts, jnp.int32)}, max_len=C)
    pc = {n: torch.as_tensor(np.array(t)) for n, t in jc.items()}
    pc["pos"] = pc["pos"].long()
    old = {n: np.array(t) for n, t in jc.items()}
    toks = rng.integers(0, VOCAB, (B, ck))
    start, nv = np.array([S0, 5, 2]), np.array([ck, 3, 0])
    jfn = jm.verify_chunk_paged if paged else jm.verify_chunk
    pfn = pm.verify_chunk_paged if paged else pm.verify_chunk
    jpred, jc2 = jax.jit(jfn)(jp, jc, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(start, jnp.int32),
                              jnp.asarray(nv, jnp.int32))
    ppred, pc2 = pfn(pp, pc, torch.as_tensor(toks), torch.as_tensor(start),
                     torch.as_tensor(nv))
    return (np.asarray(jpred), ppred.numpy(), jc2, pc2, old, start, nv)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_chunk_matches_reference(paged, kernels):
    """The argmax at every valid position equals the reference's (with
    the kernels on, the reference's Pallas calls in interpret mode and the
    port's plain versions); ``pos`` advances on active rows only; every
    written K/V entry is within 1e-5 and every other entry is unchanged
    (paged: every page but the trash page 0, which takes the port's
    padded writes)."""
    jpred, ppred, jc, pc, old, start, nv = _verify_case(paged, kernels)
    assert ppred.shape == jpred.shape == (3, 4)
    assert ppred.dtype == np.int64
    for b in range(3):
        np.testing.assert_array_equal(ppred[b, :nv[b]], jpred[b, :nv[b]])
    want_pos = np.where(nv > 0, start + nv, old["pos"])
    np.testing.assert_array_equal(pc["pos"].numpy(), want_pos)
    np.testing.assert_array_equal(np.asarray(jc["pos"]), want_pos)
    if paged:
        np.testing.assert_array_equal(pc["pt"].numpy(), np.asarray(jc["pt"]))
        for n in ("kp", "vp"):                     # (L, KV, P, ps, hd)
            np.testing.assert_allclose(to_np(pc[n])[:, :, 1:],
                                       np.asarray(jc[n])[:, :, 1:],
                                       atol=1e-5)
        return
    written = np.zeros((3, 16), bool)
    for b in range(3):
        written[b, start[b]:start[b] + nv[b]] = True
    for n in ("k", "v"):                            # (L, B, KV, C, hd)
        got = to_np(pc[n]).transpose(1, 3, 0, 2, 4)
        want = np.asarray(jc[n]).transpose(1, 3, 0, 2, 4)
        np.testing.assert_allclose(got[written], want[written], atol=1e-5)
        np.testing.assert_array_equal(
            got[~written], old[n].transpose(1, 3, 0, 2, 4)[~written])


@pytest.mark.parametrize("paged", [False, True])
def test_verify_chunk_matches_teacher_forcing(paged):
    """pred[:, j] is the greedy argmax after consuming tokens[:, :j+1]:
    one verify call is k+1 steps of target-only decoding (the port's
    ``LM.apply`` over the whole sequence is the teacher)."""
    jcfg = tiny_variants(1)["small"][0]
    _, pp = bridged_params(jcfg)
    lm = LM(port_config(jcfg))
    S, S0, k, ps = 12, 8, 3, 4
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, VOCAB,
                                                             (2, S)))
    full, _ = lm.apply(pp, {"tokens": toks})
    if paged:
        logits, pre = lm.prefill(pp, {"tokens": toks[:, :S0]}, max_len=S0)
        cache = lm.init_paged_cache(2, 2 * (S // ps) + 1, ps, S // ps,
                                    torch.device("cpu"))
        lm.paged_admit(cache, pre, torch.zeros(2, dtype=torch.int64),
                       torch.argmax(logits, -1),
                       torch.arange(1, 2 * (S // ps) + 1).reshape(2, -1),
                       torch.arange(2))
        verify = lm.verify_chunk_paged
    else:
        _, cache = lm.prefill(pp, {"tokens": toks[:, :S0]}, max_len=S)
        verify = lm.verify_chunk
    pred, _ = verify(pp, cache, toks[:, S0:S0 + k + 1],
                     torch.full((2,), S0), torch.full((2,), k + 1))
    want = torch.argmax(full[:, S0:S0 + k + 1], dim=-1)
    assert torch.equal(pred, want)


# ------------------------------------------------------ engine vs reference
def _reqs(cls, n=N_REQ, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, VOCAB, PROMPT_LEN),
                max_new=MAX_NEW, arrival=time.time()) for i in range(n)]


def _run(cls, speculative, kv_cache="dense", sharing=False,
         scheduler="fifo", async_tick=False, variants=None, **extra):
    """The reference's ``_run`` (test_spec_decode.py) on either engine:
    N_REQ requests to "big", drained. Returns (rid -> output, engine)."""
    jv = variants or tiny_variants(2)
    kw = dict(max_batch=2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
              decode_chunk=2, kv_cache=kv_cache, kv_page_size=4,
              kv_prefix_sharing=sharing, scheduler=scheduler,
              async_tick=async_tick, **extra)
    if speculative:
        kw.update(speculative=speculative, spec_k=SPEC_K)
    if cls is JEngine:
        eng, req = JEngine(jv, **kw), JRequest
    else:
        eng, req = PEngine(port_variants(jv), device="cpu",
                           weights=reference_weights(jv), **kw), PRequest
    eng.apply_allocation(0.0, {"big": 1})
    for r in _reqs(req):
        assert eng.submit(r, "big")
    eng.drain(0.0)
    assert len(eng.done) == N_REQ
    return {r.rid: [int(t) for t in r.output] for r in eng.done}, eng


_REF = {}


def _reference():
    """The reference engine's target-only outputs (invariant across KV
    layout, scheduler and tick: the reference's own tests pin that)."""
    if not _REF:
        _REF.update(_run(JEngine, None)[0])
    return _REF


SPEC_COUNTERS = ("spec.batch_rounds", "spec.rounds", "spec.committed_tokens",
                 "spec.drafts_accepted", "spec.drafts_proposed")


def _spec_record(eng):
    pair = eng.backends["big"]._spec_pair
    s = eng.summarize(60_000, 75.0)
    return ({k: eng.metrics.value(k) for k in SPEC_COUNTERS},
            pair.acceptance_stats(),
            (s["spec_accept_rate"], s["spec_tokens_per_step"]))


def _assert_pools_balanced(eng):
    """Every page of the verifier's and the drafter mirror's pools is back
    (rejected drafts never leak), and both pools are consistent."""
    b = eng.backends["big"]
    for pool in (b.pool, b._spec_pair.d.pool):
        pool.assert_invariants()
        assert pool.used_pages == 0


MATRIX = [(kv, sh, sc, at)
          for (kv, sh) in (("dense", False), ("paged", False),
                           ("paged", True))
          for sc in ("fifo", "chunked")
          for at in (False, True)]


@pytest.mark.parametrize("kv_cache,sharing,scheduler,async_tick", MATRIX)
def test_spec_matrix_matches_reference(kv_cache, sharing, scheduler,
                                       async_tick):
    """Port speculative == reference speculative == reference target-only,
    bitwise; the ``spec.*`` counters, ``acceptance_stats()`` and the
    summary's spec rates equal the reference speculative engine's; pools
    balance after the drain."""
    ref = _reference()
    got, eng = _run(PEngine, "small:big", kv_cache, sharing, scheduler,
                    async_tick)
    want, jeng = _run(JEngine, "small:big", kv_cache, sharing, scheduler,
                      async_tick)
    assert got == ref and want == ref
    assert _spec_record(eng) == _spec_record(jeng)
    assert eng.metrics.value("spec.committed_tokens") == \
        N_REQ * (MAX_NEW - 1)
    if kv_cache == "paged":
        _assert_pools_balanced(eng)


def test_correlated_twin_accepts_everything():
    """A drafter with the verifier's own weights agrees everywhere: every
    draft is accepted and each verifier step commits the 2.5 tokens the
    budget allows (MAX_NEW - 1 = 5 tokens in rounds of k + 1 = 3)."""
    variants = tiny_variants(2)
    variants["twin"] = (variants["big"][0].replace(name="twin"), 60.0)
    got, eng = _run(PEngine, "twin:big", variants=variants)
    assert got == _reference()
    s = eng.summarize(60_000, 75.0)
    assert s["spec_accept_rate"] == 1.0
    assert s["spec_tokens_per_step"] == pytest.approx(2.5)


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_spec_chunked_requeue_matches_reference(kv_cache):
    """Speculative decoding under the chunked scheduler with requeue
    preemption, on a staggered workload with tight deadlines on even rids
    (virtual clock): the port gives the reference engine's per-request
    backend, tokens, drop flag and preemption count, and its spec
    counters; preemption fired and every pool balances."""
    got, rec = {}, {}
    for cls, req in ((JEngine, JRequest), (PEngine, PRequest)):
        jv = tiny_variants(2)
        t = [0.0]
        kw = dict(max_batch=2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                  decode_chunk=2, kv_page_size=4, prefill_chunk=4,
                  kv_cache=kv_cache, scheduler="chunked",
                  preemption="requeue", speculative="small:big",
                  spec_k=SPEC_K, clock=lambda: t[0])
        eng = JEngine(jv, **kw) if cls is JEngine else PEngine(
            port_variants(jv), device="cpu", weights=reference_weights(jv),
            **kw)
        eng.t = t
        eng.apply_allocation(0.0, {"big": 1})
        got[cls] = outcome(serve_staggered(
            eng, req, tight=True, prompt_len=PROMPT_LEN, vocab=VOCAB,
            max_new=MAX_NEW, backend="big"))
        rec[cls] = {k: eng.metrics.value(k) for k in SPEC_COUNTERS}
    assert len(got[PEngine]) == 8
    assert got[PEngine] == got[JEngine]
    assert rec[PEngine] == rec[JEngine]
    assert rec[PEngine]["spec.rounds"] > 0
    assert any(o[3] for o in got[PEngine].values())       # it fired
    if kv_cache == "paged":
        _assert_pools_balanced(eng)


# ------------------------------------------------------ the port's own paths
def _state(eng):
    """Every resident cache leaf and current tokens of the verifier and of
    its drafter."""
    b = eng.backends["big"]
    return {n: {**{k: t.clone() for k, t in x.cache.items()},
                "cur_tok": x.cur_tok.clone()}
            for n, x in (("verifier", b), ("drafter", b._spec_pair.d))}


@pytest.mark.parametrize("kv_cache,async_tick", [("dense", False),
                                                 ("dense", True),
                                                 ("paged", True)])
def test_spec_static_buffers_equal_direct(kv_cache, async_tick):
    """The static-buffer path (every step through its ``StepGraph``: the
    verify, the drafter's resync, draft chunks and bootstrap chunks)
    against ``step_graphs=False``: bitwise equal outputs and cache leaves
    of verifier and drafter; the verifier has its verify step and the
    drafter its width-1 resync step."""
    runs = {}
    for graphs in (True, False):
        runs[graphs] = _run(PEngine, "small:big", kv_cache, kv_cache ==
                            "paged", "chunked", async_tick,
                            step_graphs=graphs)
    (got, eng), (want, ref) = runs[True], runs[False]
    assert got == want == _reference()
    a, b = _state(eng), _state(ref)
    for n in a:
        for k in a[n]:
            assert torch.equal(a[n][k], b[n][k]), (n, k)
    vb = eng.backends["big"]
    assert ("verify", 2) in vb.graphs
    assert ("resync", 2) in vb._spec_pair.d.graphs
    assert vb._spec_pair.d.cache_headroom == SPEC_K + 2
    assert not ref.backends["big"].graphs


def test_drain_completes_every_speculative_row():
    """Retiring the verifier mid-flight drains it: with one-token rounds
    (a drafter that rarely agrees) and a decode chunk of 4, the plain
    decode bound would stop after 3 steps, short of the 5 tokens owed;
    the speculative rounds' bound lets every request finish its budget,
    with the target-only tokens."""
    jv = tiny_variants(2)
    eng = PEngine(port_variants(jv), device="cpu",
                  weights=reference_weights(jv), max_batch=2,
                  prompt_len=PROMPT_LEN, max_new=MAX_NEW, decode_chunk=4,
                  speculative="small:big", spec_k=SPEC_K)
    eng.apply_allocation(0.0, {"big": 1})
    for r in _reqs(PRequest, n=2):
        assert eng.submit(r, "big")
    eng.step(0.0)                          # admit both; one round
    eng.apply_allocation(0.0, {"small": 1})
    assert len(eng.done) == 2
    ref = _reference()
    for r in eng.done:
        assert [int(t) for t in r.output] == ref[r.rid]


@pytest.mark.parametrize("kw", [
    dict(speculative="big"), dict(speculative="big:big"),
    dict(speculative="small:nope"), dict(speculative=":big"),
    dict(speculative="small:big", spec_k=0),
    dict(speculative="small:big", spec_k=MAX_NEW + 1),
    dict(speculative="small:big", mode="pump")])
def test_spec_refusals(kw):
    """A bad drafter:verifier string, a variant the engine does not serve,
    spec_k outside 1..max_new and the pump path raise."""
    with pytest.raises(ValueError):
        PEngine(port_variants(tiny_variants(2)), device="cpu", max_batch=2,
                prompt_len=PROMPT_LEN, max_new=MAX_NEW, **kw)
