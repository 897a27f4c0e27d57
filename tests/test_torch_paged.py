"""The port's paged KV engine against the reference on the CPU: the pool
bookkeeping (``PagedKVCache``) under one seeded schedule, the paged
kernel's plain version against the reference's Pallas kernel (interpret
mode) and oracle, paged decode and chunk-prefill attention, the paged
``LM`` methods with bridged weights, and both engines on the same
requests with prefix sharing off and on. fp32 tolerance 1e-5 absolute
(both sides accumulate in fp32, in different orders); bf16 3e-2 (the
kernel and the oracle each round an fp32 result to bf16)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_variants

from _torch_parity import bridged_params, np_tree, port_config, to_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as ja
from repro.models.attention import PagedKVCache as JPool
from repro.models.model import build_model as jbuild
from repro.obs.registry import MetricsRegistry as JRegistry
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.kernels import paged_decode as pd
from repro_torch.models import attention as pa
from repro_torch.models.attention import PagedKVCache as PPool
from repro_torch.models.model import LM
from repro_torch.obs.registry import MetricsRegistry as PRegistry
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.engine import InProcessServingEngine as PEngine

ATOL = {"float32": 1e-5, "bfloat16": 3e-2}

# --------------------------------------------------------------- the pool

_POOL_COUNTERS = ("prefix_lookups", "prefix_hits", "fresh_pages_allocated",
                  "shared_page_maps")
_POOL_METRICS = ("kv.prefix_lookups", "kv.prefix_hits", "kv.pages_allocated",
                 "kv.shared_page_maps", "kv.retained_reclaimed",
                 "kv.retained_revived", "kv.pages_retained", "kv.rollbacks")


def _pool_state(pool, reg):
    return (list(pool._free), dict(pool._ref), list(pool._retained),
            dict(pool._index), dict(pool._page_key),
            {s: list(p) for s, p in pool._owned.items()},
            [getattr(pool, c) for c in _POOL_COUNTERS],
            [reg.value(m) for m in _POOL_METRICS])


def _both(pools, method, *args, **kw):
    """Call ``method`` on both pools; their results (or error types) and
    whole states must agree afterwards."""
    outs = []
    for pool, _ in pools:
        try:
            out = getattr(pool, method)(*args, **kw)
            if hasattr(out, "tail_start"):      # a PrefixPlan of either
                out = (out.shared, out.cow_src, out.tail_start)
            outs.append(("ok", out))
        except ValueError:
            outs.append(("ValueError", None))
    assert outs[0] == outs[1], (method, args, kw, outs)
    assert _pool_state(*pools[0]) == _pool_state(*pools[1]), (method, args)
    pools[1][0].assert_invariants()
    return outs[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_schedule_matches_reference(seed):
    """One seeded schedule of alloc (with shared and protected pages),
    free, publish, plan, rollback and the error cases on both pools: every
    result, the free list, refcounts, retained tier, index and counters
    stay equal after every operation."""
    rng = np.random.default_rng(seed)
    ps, per_slot, n_slots = 4, 3, 5
    pools = [(JPool(11, ps, metrics=JRegistry()), None),
             (PPool(11, ps, metrics=PRegistry()), None)]
    pools = [(p, p.metrics) for p, _ in pools]
    prefixes = [rng.integers(0, 50, 8) for _ in range(3)]
    prompts = {}
    for _ in range(160):
        live = sorted(pools[1][0]._owned)
        op = rng.choice(["alloc", "alloc", "free", "publish", "rollback",
                         "plan", "error"])
        if op == "alloc":
            slot = int(rng.integers(n_slots))
            toks = np.concatenate([prefixes[rng.integers(3)],
                                   rng.integers(0, 3, int(rng.integers(0, 5)))])
            _, (shared, cow, _) = _both(pools, "prefix_plan", toks)
            shared = shared if rng.random() < 0.8 else ()
            protect = (cow,) if cow is not None else ()
            _, fresh = _both(pools, "alloc", slot, per_slot - len(shared),
                             shared=shared, protect=protect)
            if fresh is not None:
                prompts[slot] = toks
        elif op == "free" and live:
            _both(pools, "free", int(rng.choice(live)))
        elif op == "publish" and live:
            slot = int(rng.choice(live))
            _both(pools, "publish_prefix", slot, prompts[slot])
        elif op == "rollback" and live:
            _both(pools, "rollback", int(rng.choice(live)),
                  int(rng.integers(-1, per_slot * ps + 3)))
        elif op == "plan":
            _both(pools, "prefix_plan", prefixes[rng.integers(3)],
                  count=bool(rng.integers(2)))
        elif op == "error":
            kind = rng.integers(4)
            if kind == 0 and live:                       # double alloc
                _both(pools, "alloc", int(live[0]), 1)
            elif kind == 1:                              # free unowned
                _both(pools, "free", n_slots + 1)
            elif kind == 2:                              # share trash page
                _both(pools, "alloc", n_slots + 2, 1, shared=(0,))
            else:                                        # publish unowned
                _both(pools, "publish_prefix", n_slots + 3, prefixes[0])
    assert pools[0][0].prefix_hits > 0


# ------------------------------------------------- the kernel's plain form

def _paged_np(rng, B, KV, G, hd, ps, width):
    P = B * width + 1
    q = rng.standard_normal((B, KV, G, hd), dtype=np.float32)
    kp = rng.standard_normal((KV, P, ps, hd), dtype=np.float32)
    vp = rng.standard_normal((KV, P, ps, hd), dtype=np.float32)
    tables = rng.permutation(np.arange(1, P)).reshape(B, width)
    lengths = rng.integers(1, width * ps + 1, B)
    lengths[1] = 0                                  # a dead row
    return q, kp, vp, tables.astype(np.int32), lengths.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("G,ps", [(1, 8), (4, 16)])
def test_plain_paged_decode_matches_pallas_and_oracle(G, ps, softcap,
                                                      dtype):
    q, kp, vp, tables, lengths = _paged_np(np.random.default_rng(G), 4, 2,
                                           G, 64, ps, 5)
    tdt = getattr(torch, dtype)
    got = to_np(pd.paged_flash_decode_plain(
        *(torch.as_tensor(a).to(tdt) for a in (q, kp, vp)),
        torch.as_tensor(tables), torch.as_tensor(lengths), softcap=softcap))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, kp, vp))
    pallas = jops.paged_flash_decode(jq, jk, jv, jnp.asarray(tables),
                                     jnp.asarray(lengths), softcap=softcap)
    oracle = jref.ref_paged_decode(jq, jk, jv, jnp.asarray(tables),
                                   jnp.asarray(lengths), softcap=softcap)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=ATOL[dtype])
    assert not got[1].any()                         # length 0 -> zeros


# ------------------------------------------------------- attention layers

def _attn_cfgs(kernels, kv, softcap=0.0):
    from repro.configs import get_config, smoke_variant
    jc = smoke_variant(get_config("tinyllama-1.1b")).replace(
        d_model=128, num_heads=4, num_kv_heads=kv, head_dim=64,
        attn_logit_softcap=softcap, use_pallas=kernels)
    jp = ja.init_attention(jax.random.PRNGKey(0), jc)
    return jc, port_config(jc), jp, {k: torch.as_tensor(v)
                                     for k, v in np_tree(jp).items()}


def _pool_inputs(rng, B, KV, ps, max_pages):
    P = B * max_pages + 1
    kp = rng.standard_normal((KV, P, ps, 64), dtype=np.float32)
    vp = rng.standard_normal((KV, P, ps, 64), dtype=np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(B, max_pages)
    return kp, vp, pt.astype(np.int32)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("kernels", [False, True])
def test_paged_decode_attention(kernels, kv, softcap):
    jc, pc, jp, pp = _attn_cfgs(kernels, kv, softcap)
    rng = np.random.default_rng(kv)
    B, ps, max_pages, n_pages = 3, 4, 6, 4
    kp, vp, pt = _pool_inputs(rng, B, kv, ps, max_pages)
    pt[2] = 0                                       # a dead row: trash page
    pos = np.array([5, n_pages * ps - 1, 30])
    x = rng.standard_normal((B, 1, 128), dtype=np.float32)
    ja_out, jk, jv = jax.jit(ja.paged_decode_attention, static_argnums=0,
                             static_argnames="n_pages")(
        jc, jp, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(pos, jnp.int32), n_pages=n_pages)
    tk, tv = torch.as_tensor(kp), torch.as_tensor(vp)
    pa_out, pk, pv = pa.paged_decode_attention(
        pc, pp, torch.as_tensor(x), tk, tv, torch.as_tensor(pt),
        torch.as_tensor(pos), n_pages=n_pages)
    assert pk is tk and pv is tv                    # written in place
    np.testing.assert_allclose(to_np(pa_out)[:2], np.asarray(ja_out)[:2],
                               atol=1e-5)
    np.testing.assert_allclose(to_np(pk), np.asarray(jk), atol=1e-6)
    np.testing.assert_allclose(to_np(pv), np.asarray(jv), atol=1e-6)


@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("kernels", [False, True])
def test_paged_chunk_prefill_attention(kernels, kv):
    jc, pc, jp, pp = _attn_cfgs(kernels, kv)
    rng = np.random.default_rng(10 + kv)
    B, ck, ps, max_pages = 3, 5, 4, 4
    kp, vp, pt = _pool_inputs(rng, B, kv, ps, max_pages)
    start = np.array([0, 6, 9])
    n_valid = np.array([5, 2, 0])                   # row 2 inert
    x = rng.standard_normal((B, ck, 128), dtype=np.float32)
    j_out, jk, jv = jax.jit(ja.paged_chunk_prefill_attention,
                            static_argnums=0)(
        jc, jp, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(start, jnp.int32),
        jnp.asarray(n_valid, jnp.int32))
    p_out, pk, pv = pa.paged_chunk_prefill_attention(
        pc, pp, torch.as_tensor(x), torch.as_tensor(kp), torch.as_tensor(vp),
        torch.as_tensor(pt), torch.as_tensor(start), torch.as_tensor(n_valid))
    for b in range(B):
        np.testing.assert_allclose(to_np(p_out)[b, :n_valid[b]],
                                   np.asarray(j_out)[b, :n_valid[b]],
                                   atol=1e-5)
    # every page but the trash page 0 (the port's sink for dropped writes)
    np.testing.assert_allclose(to_np(pk)[:, 1:], np.asarray(jk)[:, 1:],
                               atol=1e-6)
    np.testing.assert_allclose(to_np(pv)[:, 1:], np.asarray(jv)[:, 1:],
                               atol=1e-6)


# ------------------------------------------------------------- the paged LM

@pytest.mark.parametrize("kernels", [False, True])
def test_paged_lm_methods_match_reference(kernels):
    """Prefill -> paged_admit -> 8 greedy decode_step_paged steps, then a
    CoW copy, a retire and a two-chunk prefill continuation into a fresh
    slot: logits within 1e-5, identical greedy tokens, equal pools."""
    jcfg = tiny_variants(1, num_kv_heads=2)["small"][0].replace(
        use_pallas=kernels)
    jp, pp = bridged_params(jcfg)
    jm, pm = jbuild(jcfg), LM(port_config(jcfg))
    j_prefill = jax.jit(jm.prefill, static_argnames="max_len")
    j_admit = jax.jit(jm.paged_admit)
    j_decode = jax.jit(jm.decode_step_paged, static_argnames="n_pages")
    j_chunk = jax.jit(jm.prefill_chunk_paged)
    B, S, ps, pages_per = 3, 8, 4, 4
    P = B * pages_per + 1
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, S))
    page_ids = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    dest = np.array([2, 0])
    jc = jm.init_paged_cache(B, P, ps, pages_per)
    pc = pm.init_paged_cache(B, P, ps, pages_per, torch.device("cpu"))
    jl, jpre = j_prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         max_len=S)
    pl, ppre = pm.prefill(pp, {"tokens": torch.as_tensor(toks)}, max_len=S)
    np.testing.assert_allclose(to_np(pl), np.asarray(jl), atol=1e-5)
    jtok, ptok = jnp.zeros((B,), jnp.int32), torch.zeros(B, dtype=torch.int64)
    jfirst = jnp.argmax(jl, -1).astype(jnp.int32)
    jc, jtok = j_admit(jc, jpre, jtok, jfirst,
                       jnp.asarray(page_ids, jnp.int32),
                       jnp.asarray(dest, jnp.int32))
    pc, ptok = pm.paged_admit(pc, ppre, ptok, torch.argmax(pl, -1),
                              torch.as_tensor(page_ids),
                              torch.as_tensor(dest))
    j_seq, p_seq = [], []
    for _ in range(8):
        jlog, jc = j_decode(jp, jc, jtok, n_pages=pages_per)
        plog, pc = pm.decode_step_paged(pp, pc, ptok, n_pages=pages_per)
        np.testing.assert_allclose(to_np(plog)[dest], np.asarray(jlog)[dest],
                                   atol=1e-5)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ptok = torch.argmax(plog, -1)
        j_seq.append(np.asarray(jtok)[dest])
        p_seq.append(ptok.numpy()[dest])
    np.testing.assert_array_equal(np.stack(p_seq), np.stack(j_seq))
    jc = jm.paged_cow_copy(jc, 5, 9)
    jc = jm.paged_retire(jc, 0)
    pm.paged_cow_copy(pc, 5, 9)
    pm.paged_retire(pc, 0)
    # a prefill continuation in two chunks into slot 1 (pages 9..12)
    pt1 = np.array([9, 10, 11, 12])
    jc["pt"] = jc["pt"].at[1].set(jnp.asarray(pt1, jnp.int32))
    pc["pt"][1] = torch.as_tensor(pt1, dtype=torch.int32)
    seq = rng.integers(0, jcfg.vocab_size, 7)
    for lo, hi in ((0, 4), (4, 7)):
        chunk = np.zeros((B, 4), np.int64)
        chunk[1, :hi - lo] = seq[lo:hi]
        start, nv = np.array([0, lo, 0]), np.array([0, hi - lo, 0])
        jlog, jc = j_chunk(jp, jc, jnp.asarray(chunk, jnp.int32),
                           jnp.asarray(start, jnp.int32),
                           jnp.asarray(nv, jnp.int32))
        plog, pc = pm.prefill_chunk_paged(
            pp, pc, torch.as_tensor(chunk), torch.as_tensor(start),
            torch.as_tensor(nv))
        np.testing.assert_allclose(to_np(plog)[1], np.asarray(jlog)[1],
                                   atol=1e-5)
    np.testing.assert_array_equal(pc["pos"].numpy()[1:],
                                  np.asarray(jc["pos"])[1:])
    np.testing.assert_array_equal(pc["pt"].numpy(), np.asarray(jc["pt"]))
    for key in ("kp", "vp"):                        # live pages; not trash
        np.testing.assert_allclose(to_np(pc[key])[:, :, 1:],
                                   np.asarray(jc[key])[:, :, 1:], atol=1e-5)


# ------------------------------------------------------------- the engines

_PROMPT_LEN, _MAX_NEW = 16, 6


def _shared_prompts():
    """Five 16-token prompts over one 8-token system prefix, three of them
    identical (the full-prompt match that exercises the CoW boundary) —
    the reference's ``test_paged_engine`` prefix-sharing pattern."""
    rng = np.random.default_rng(9)
    pre = rng.integers(0, 128, 8)
    p0 = np.concatenate([pre, rng.integers(0, 128, 8)])
    return [p0, np.concatenate([pre, rng.integers(0, 128, 8)]), p0,
            np.concatenate([pre, rng.integers(0, 128, 8)]), p0]


def _serve_shared(eng, req_cls):
    """Request 0 is admitted one tick early, so the rest overlap a live,
    published prefix; then drain. Returns {rid: tokens}."""
    eng.apply_allocation(0.0, {"small": 1})
    prompts = _shared_prompts()
    eng.submit(req_cls(rid=0, tokens=prompts[0], max_new=_MAX_NEW,
                       arrival=time.time()), "small")
    eng.step(0.0)
    for i in range(1, len(prompts)):
        eng.submit(req_cls(rid=i, tokens=prompts[i], max_new=_MAX_NEW,
                           arrival=time.time()), "small")
    eng.drain(0.0)
    assert len(eng.done) == len(prompts)
    pool = eng.backends["small"].pool
    pool.assert_invariants()
    assert pool.used_pages == 0            # every page returned, shared too
    return {r.rid: [int(t) for t in r.output] for r in eng.done}


def _geometry(page, sharing):
    return dict(max_batch=3, prompt_len=_PROMPT_LEN, max_new=_MAX_NEW,
                decode_chunk=2, kv_cache="paged", kv_page_size=page,
                kv_prefix_sharing=sharing)


# each value of each axis appears; the port-only test below covers the
# rest of the sharing x page x GQA matrix
@pytest.mark.parametrize("sharing,page,gqa", [
    (False, 4, True), (True, 4, True), (True, 8, False), (False, 8, False)])
def test_engines_give_identical_outputs_paged(sharing, page, gqa):
    jv = tiny_variants(1, num_kv_heads=2 if gqa else 4)
    jeng = JEngine(jv, **_geometry(page, sharing))
    jeng.apply_allocation(0.0, {"small": 1})
    from repro_torch.bridge import params_from_jax
    weights = {"small": params_from_jax(
        np_tree(jeng.backends["small"].params), port_config(jv["small"][0]),
        "cpu")}
    peng = PEngine({n: (port_config(c), a) for n, (c, a) in jv.items()},
                   device="cpu", weights=weights, **_geometry(page, sharing))
    want = _serve_shared(jeng, JRequest)
    got = _serve_shared(peng, PRequest)
    assert got == want
    jb, pb = jeng.backends["small"], peng.backends["small"]
    assert pb.prefill_tokens_total == jb.prefill_tokens_total
    assert pb.pool.prefix_hits == jb.pool.prefix_hits
    assert (pb.pool.prefix_hits > 0) == sharing
    assert peng.kv_pool_stats() == jeng.kv_pool_stats()
    assert peng.metrics.value("kv.cow_copies") == \
        jeng.metrics.value("kv.cow_copies")
    sj, sp = jeng.summarize(60_000, 70.0), peng.summarize(60_000, 70.0)
    assert set(sp) == set(sj) and sp["pending"] == 0


@pytest.mark.parametrize("page,gqa", [(4, False), (8, True), (16, True)])
def test_port_sharing_on_equals_off(page, gqa):
    """Inside the port, prefix sharing changes which pages hold the prompt
    and how much is prefilled, never the tokens: bitwise-equal outputs,
    with hits and CoW copies on, and fewer prefill tokens."""
    jv = tiny_variants(1, num_kv_heads=2 if gqa else 4)
    pv = {n: (port_config(c), a) for n, (c, a) in jv.items()}
    outs, engines = [], []
    for sharing in (False, True):
        eng = PEngine(pv, device="cpu", **_geometry(page, sharing))
        outs.append(_serve_shared(eng, PRequest))
        engines.append(eng)
    off, on = engines
    assert outs[0] == outs[1]
    assert on.kv_pool_stats()["prefix_hits"] > 0
    assert on.metrics.value("kv.cow_copies") > 0
    assert on.backends["small"].prefill_tokens_total < \
        off.backends["small"].prefill_tokens_total


def test_small_pool_gates_admission():
    """A pool that holds two slots' budgets admits two requests at a time
    out of four free slots; every request still completes, no page leaks,
    and the outputs equal a full-size pool's."""
    pv = {n: (port_config(c), a) for n, (c, a) in tiny_variants(1).items()}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, _PROMPT_LEN) for _ in range(6)]
    outs = []
    for pool_pages in (None, 2 * 6 + 1):        # 6 pages per slot budget
        eng = PEngine(pv, device="cpu", max_batch=4, prompt_len=_PROMPT_LEN,
                      max_new=8, decode_chunk=2, kv_cache="paged",
                      kv_page_size=4, kv_pool_pages=pool_pages)
        eng.apply_allocation(0.0, {"small": 1})
        b = eng.backends["small"]
        for i, p in enumerate(prompts):
            eng.submit(PRequest(rid=i, tokens=p, max_new=8,
                                arrival=time.time()), "small")
        peak = 0
        while eng.backlog(0.0) or eng.in_flight():
            eng.step(0.0)
            peak = max(peak, b.active_slots)
            b.pool.assert_invariants()
        assert peak == (4 if pool_pages is None else 2)
        assert b.pool.used_pages == 0 and len(eng.done) == len(prompts)
        outs.append({r.rid: list(r.output) for r in eng.done})
    assert outs[0] == outs[1]


@pytest.mark.parametrize("option", [
    dict(kv_cache="ring"), dict(kv_cache="paged", mode="pump"),
    dict(kv_prefix_sharing=True)])
def test_invalid_kv_options_raise(option):
    pv = {n: (port_config(c), a) for n, (c, a) in tiny_variants(1).items()}
    with pytest.raises(ValueError):
        PEngine(pv, device="cpu", **option)
