"""The port's Mamba-2 SSD path against the reference on the CPU: the plain
chunked scan (the CUDA kernel's plain version) against the reference's
``ssd_chunked``, its Pallas kernel in interpret mode and the naive
recurrence; the mixer and its caches; the ``ssm`` and ``hybrid`` smoke LMs
(logits, caches, greedy continuations) with bridged weights; the bridge's
leaves and dtypes; and both engines on the mamba2 smoke ladder.

Tolerances (fp32): the scan against ``ssd_chunked`` and Pallas within
1e-5 of the output's largest magnitude (y reaches ~150 here, sums of up
to 128 decayed products of B.C ~ sqrt(n); the two sides sum in other
orders, ~3e-6 of max |y| apart), and against the naive recurrence within
5e-3 absolute / 1e-3 relative, as the reference's own tests use; 1e-5 on
mixer outputs and caches; 1e-4 on logits, as in ``test_torch_model``."""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (bridged_params, np_tree, port_config,
                           reference_init, to_np)
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import build_ladder as jladder
from repro.models import ssd as jssd
from repro.models.model import build_model as jbuild
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.bridge import expected_shapes, params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_ladder as pladder
from repro_torch.models import ssd as pssd
from repro_torch.models.model import LM
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.engine import InProcessServingEngine as PEngine

SCAN_REL = 1e-5
NAIVE_TOL = dict(atol=5e-3, rtol=1e-3)
MIXER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
ARCHS = ("mamba2-130m", "hymba-1.5b")

# tests/test_kernels_ssd.py SHAPES: b, s, h, p, n, chunk
SHAPES = [
    (2, 128, 4, 32, 16, 64),
    (1, 256, 8, 64, 32, 128),
    (2, 64, 2, 16, 8, 32),
    (1, 64, 24, 64, 128, 64),   # mamba2-130m head geometry
]


def _scan_inputs(seed, b, s, h, p, n):
    """x, dt (softplus), A (negative), B, C, initial state (x 0.1)."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    dt = np.log1p(np.exp(f(b, s, h)))
    return (f(b, s, h, p), dt, -np.abs(f(h)), f(b, s, n), f(b, s, n),
            f(b, h, p, n) * 0.1)


def _scan_close(got, want):
    """|got - want| <= SCAN_REL * max |want|, elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, rtol=0,
                               atol=SCAN_REL * np.abs(want).max())


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


# ---------------------------------------------------------------- the scan

@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_scan_matches_reference_pallas_and_naive(b, s, h, p, n, chunk):
    args = _scan_inputs(s + n, b, s, h, p, n)
    x, dt, A, B, C, init = _t(*args)
    y, st = pssd.ssd_chunked(x, dt, A, B, C, chunk, init)
    yo, sto = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=init)
    torch.testing.assert_close(yo, y, rtol=0, atol=0)   # CPU: the same code
    torch.testing.assert_close(sto, st, rtol=0, atol=0)
    jx, jdt, jA, jB, jC, jinit = _j(*args)
    want = jssd.ssd_chunked(jx, jdt, jA, jB, jC, chunk, jinit)
    pallas = jops.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                           initial_state=jinit)
    naive = jref.ref_ssd(jx, jdt, jA, jB, jC, initial_state=jinit)
    for wy, ws in (want, pallas):
        _scan_close(y, wy)
        _scan_close(st, ws)
    np.testing.assert_allclose(to_np(y), np.asarray(naive[0]), **NAIVE_TOL)
    np.testing.assert_allclose(to_np(st), np.asarray(naive[1]), **NAIVE_TOL)


def test_scan_state_chaining():
    """Two halves with the carried state equal the whole sequence."""
    x, dt, A, B, C, _ = _t(*_scan_inputs(3, 1, 128, 2, 16, 8))
    y, st = ops.ssd_scan(x, dt, A, B, C, chunk=32)
    y1, s1 = ops.ssd_scan(x[:, :64], dt[:, :64], A, B[:, :64], C[:, :64],
                          chunk=32)
    y2, s2 = ops.ssd_scan(x[:, 64:], dt[:, 64:], A, B[:, 64:], C[:, 64:],
                          chunk=32, initial_state=s1)
    _scan_close(torch.cat([y1, y2], 1), y)
    _scan_close(s2, st)


def test_ragged_scan_equals_padded_reference():
    """s not a chunk multiple: the plain dispatch pads as ``ssm_forward``
    does in the reference, and the result is the reference's on the padded
    sequence, sliced."""
    b, s, h, p, n, chunk = 2, 45, 3, 16, 8, 16
    args = _scan_inputs(11, b, s, h, p, n)
    y, st = ops.ssd_scan(*_t(*args[:5]), chunk=chunk,
                         initial_state=torch.as_tensor(args[5]))
    pad = (-s) % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (args[0], args[1])]
    jx, jdt = _j(*padded)
    jB, jC = _j(*(np.pad(a, [(0, 0), (0, pad), (0, 0)])
                  for a in (args[3], args[4])))
    wy, ws = jssd.ssd_chunked(jx, jdt, jnp.asarray(args[2]), jB, jC, chunk,
                              jnp.asarray(args[5]))
    _scan_close(y, np.asarray(wy)[:, :s])
    _scan_close(st, ws)
    assert ops.launch_counts()["ssd_scan"] == 0        # CPU: never launched


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((3, 7), dtype=np.float32)
    got = to_np(pssd.segsum(torch.as_tensor(x)))
    want = np.asarray(jssd.segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6)


# --------------------------------------------------------------- the mixer

def _smoke(arch, **kw):
    return jsmoke(jget_config(arch)).replace(**kw)


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=0):
    """(reference params, port params) of ``arch``'s smoke config, drawn
    once per module: the weights do not depend on ``use_pallas`` or
    ``ssd_chunk``, which the tests vary (callers never mutate them)."""
    return bridged_params(_smoke(arch), seed)


def _mixer(arch="mamba2-130m", **kw):
    """(reference cfg, port cfg, layer-0 SSM params: reference, port)."""
    jcfg = _smoke(arch, **kw)
    jp, pp = _weights(arch)
    return (jcfg, port_config(jcfg),
            jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ssm"]),
            {k: v[0] for k, v in pp["layers"]["ssm"].items()})


# the reference mixer, jitted (eager JAX dispatch would dominate these
# tests' time); the config is a static (hashable) argument
_jssm_forward = jax.jit(jssd.ssm_forward, static_argnums=(0,),
                        static_argnames=("return_cache",))
_jssm_decode = jax.jit(jssd.ssm_decode, static_argnums=(0,))


def _close(got, want, atol=MIXER_ATOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=atol)


def test_causal_conv1d_and_conv_decode_step():
    _, _, jl, pl = _mixer()
    rng = np.random.default_rng(1)
    ch = jl["conv_w"].shape[1]
    u = rng.standard_normal((2, 9, ch), dtype=np.float32)
    _close(pssd.causal_conv1d(torch.as_tensor(u), pl["conv_w"], pl["conv_b"]),
           jssd.causal_conv1d(jnp.asarray(u), jl["conv_w"], jl["conv_b"]))
    state = rng.standard_normal((2, 3, ch), dtype=np.float32)
    got = pssd.conv_decode_step(torch.as_tensor(u[:, 0]),
                                torch.as_tensor(state), pl["conv_w"],
                                pl["conv_b"])
    want = jssd.conv_decode_step(jnp.asarray(u[:, 0]), jnp.asarray(state),
                                 jl["conv_w"], jl["conv_b"])
    for g, w in zip(got, want):
        _close(g, w)


def test_ssd_decode_step():
    x, dt, A, B, C, st = _scan_inputs(5, 2, 1, 4, 16, 8)
    got = pssd.ssd_decode_step(*_t(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                   st))
    want = jssd.ssd_decode_step(*_j(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                    st))
    for g, w in zip(got, want):
        _close(g, w)


# S < cw-1, S = cw-1, ragged against the chunk (8), a chunk multiple
@pytest.mark.parametrize("S", [2, 3, 13, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_forward_with_cache(S, with_state):
    jcfg, pcfg, jl, pl = _mixer(ssd_chunk=8)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    init = None
    if with_state:
        init = rng.standard_normal((2, jcfg.ssm_heads, jcfg.ssm_head_dim,
                                    jcfg.ssm_state), dtype=np.float32)
    out, (conv, st) = pssd.ssm_forward(
        pcfg, pl, torch.as_tensor(x),
        None if init is None else torch.as_tensor(init), return_cache=True)
    jout, (jconv, jst) = _jssm_forward(
        jcfg, jl, jnp.asarray(x), None if init is None else jnp.asarray(init),
        return_cache=True)
    for g, w in ((out, jout), (conv, jconv), (st, jst)):
        _close(g, w)
    assert conv.dtype == torch.float32 and st.dtype == torch.float32


def test_ssm_decode_continues_the_forward_cache():
    jcfg, pcfg, jl, pl = _mixer()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, jcfg.d_model), dtype=np.float32)
    _, (conv, st) = pssd.ssm_forward(pcfg, pl, torch.as_tensor(x[:, :5]),
                                     return_cache=True)
    _, (jconv, jst) = _jssm_forward(jcfg, jl, jnp.asarray(x[:, :5]),
                                    return_cache=True)
    got = pssd.ssm_decode(pcfg, pl, torch.as_tensor(x[:, 5:]), conv, st)
    want = _jssm_decode(jcfg, jl, jnp.asarray(x[:, 5:]), jconv, jst)
    for g, w in zip(got, want):
        _close(g, w)
    # one decode step == the last position of a 6-token forward
    full = pssd.ssm_forward(pcfg, pl, torch.as_tensor(x))
    torch.testing.assert_close(got[0][:, 0], full[:, 5], atol=MIXER_ATOL,
                               rtol=0)


def test_kernel_switch_is_the_same_on_cpu():
    """``use_kernels`` routes the scan through ``ops.ssd_scan``, whose CPU
    dispatch is the plain version: identical outputs, no launch."""
    _, pcfg, _, pl = _mixer(ssd_chunk=8)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 13, pcfg.d_model), dtype=np.float32))
    ops.reset_launch_counts()
    off = pssd.ssm_forward(pcfg, pl, x, return_cache=True)
    on = pssd.ssm_forward(pcfg.replace(use_kernels=True), pl, x,
                          return_cache=True)
    torch.testing.assert_close(on[0], off[0], rtol=0, atol=0)
    torch.testing.assert_close(on[1][1], off[1][1], rtol=0, atol=0)
    assert ops.launch_counts()["ssd_scan"] == 0


# ------------------------------------------------------------------ bridge

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}".lstrip("."))
    else:
        yield prefix, tree


PARAM_DTYPE = {"ln1", "ln2", "final_norm", "conv_w", "conv_b", "A_log",
               "D_skip", "dt_bias", "norm_w", "mix_scale"}


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_init_leaves_shapes_and_dtypes(arch):
    jcfg = _smoke(arch)
    jp = np_tree(reference_init(jcfg))
    pcfg = port_config(jcfg)
    shapes = dict(_leaves(expected_shapes(pcfg)))
    assert shapes == {k: v.shape for k, v in _leaves(jp)}
    assert ("layers.ssm.in_proj" in shapes) and \
        (("layers.attn.wq" in shapes) == (arch == "hymba-1.5b"))
    bridged = params_from_jax(jp, pcfg, "cpu", dtype=torch.bfloat16)
    init = LM(pcfg.replace(dtype="bfloat16")).init(
        torch.Generator().manual_seed(0))
    for tree in (bridged, init):
        for k, t in _leaves(tree):
            assert tuple(t.shape) == shapes[k], k
            keep = k.split(".")[-1] in PARAM_DTYPE
            assert t.dtype == (torch.float32 if keep else torch.bfloat16), k
    fp32 = dict(_leaves(params_from_jax(jp, pcfg, "cpu")))
    for k, v in _leaves(jp):
        np.testing.assert_array_equal(to_np(fp32[k]), v)


def test_bridge_rejects_a_missing_ssm_leaf():
    jp = np_tree(reference_init(_smoke("mamba2-130m")))
    del jp["layers"]["ssm"]["dt_bias"]
    with pytest.raises(ValueError):
        params_from_jax(jp, port_config(_smoke("mamba2-130m")), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_len", [12, 40])
def test_init_cache_matches_reference(arch, max_len):
    jcfg = _smoke(arch)
    want = jbuild(jcfg).init_cache(3, max_len)
    got = LM(port_config(jcfg)).init_cache(3, max_len, torch.device("cpu"))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    assert got["ssd"].dtype == torch.float32
    assert ("k" in got) == (arch == "hymba-1.5b")


# --------------------------------------------------------------------- LM

def _jitted(jcfg):
    jm = jbuild(jcfg)
    return (jax.jit(jm.prefill, static_argnames=("max_len",)),
            jax.jit(jm.decode_step))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


LM_CASES = [(a, pallas) for a in ARCHS for pallas in (False, True)]
LM_IDS = [f"{a}-{'pallas' if p else 'jnp'}" for a, p in LM_CASES]


@pytest.mark.parametrize("arch,pallas", LM_CASES, ids=LM_IDS)
def test_lm_apply_matches(arch, pallas):
    jcfg = _smoke(arch, use_pallas=pallas, ssd_chunk=8)
    jp, pp = _weights(arch)
    toks = _tokens(jcfg, 2, 13, seed=3)
    want, _ = jbuild(jcfg).apply(jp, {"tokens": jnp.asarray(toks)})
    got, _ = LM(port_config(jcfg, use_kernels=False)).apply(
        pp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=LOGIT_ATOL)


# 2nd case: S >= the hybrid's ring capacity (window 16)
@pytest.mark.parametrize("S,max_len", [(12, 24), (20, 28)])
@pytest.mark.parametrize("arch,pallas", LM_CASES, ids=LM_IDS)
def test_lm_prefill_caches_and_greedy_continuation(arch, pallas, S, max_len):
    """Prefill logits and every cache leaf, then 8 greedy decode steps with
    identical tokens (past the hybrid's 16-slot ring, which its global
    layer 0 shares)."""
    jcfg = _smoke(arch, use_pallas=pallas)
    jp, pp = _weights(arch, seed=1)
    (jprefill, jdecode) = _jitted(jcfg)
    pm = LM(port_config(jcfg, use_kernels=False))
    toks = _tokens(jcfg, 2, S, seed=S)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    pl, pc = pm.prefill(pp, {"tokens": torch.as_tensor(toks)},
                        max_len=max_len)
    np.testing.assert_allclose(to_np(pl), np.asarray(jl), atol=LOGIT_ATOL)
    assert set(pc) == set(jc)
    for key in jc:
        _close(pc[key], jc[key])
    jseq, pseq = [], []
    for _ in range(8):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        pt = torch.argmax(pl, dim=-1)
        jseq.append(np.asarray(jt))
        pseq.append(pt.numpy())
        jl, jc = jdecode(jp, jc, jt)
        pl, pc = pm.decode_step(pp, pc, pt)
        np.testing.assert_allclose(to_np(pl), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    np.testing.assert_array_equal(np.stack(pseq), np.stack(jseq))
    for key in jc:
        _close(pc[key], jc[key])


def test_families_refuse_paged_and_chunked_forms():
    for arch in ARCHS:
        lm = LM(port_config(_smoke(arch)))
        assert not lm.supports_paged_cache()
        assert not lm.supports_chunked_prefill()
        assert jbuild(_smoke(arch)).supports_paged_cache() is False


# ------------------------------------------------------------------ engine

GEOMETRY = dict(max_batch=2, prompt_len=8, max_new=6, decode_chunk=2)


def _requests(cls, n, seed, vocab):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, GEOMETRY["prompt_len"] + 1, n)
    budgets = rng.integers(1, GEOMETRY["max_new"] + 3, n)
    return [cls(rid=i, tokens=rng.integers(0, vocab, int(lens[i])),
                max_new=int(budgets[i]), arrival=time.time())
            for i in range(n)]


def _serve(engine, reqs, names):
    engine.apply_allocation(0.0, {n: 1 for n in names})
    for r in reqs:
        assert engine.submit(r, names[r.rid % len(names)])
    engine.drain(0.0) if engine.mode == "continuous" else engine.pump(0.0)
    return {r.rid: (r.backend, list(r.output)) for r in engine.done}


def _engines(jv, mode):
    names = list(jv)
    jeng = JEngine(jv, mode=mode, **GEOMETRY)
    jeng.apply_allocation(0.0, {n: 1 for n in names})
    weights = {n: params_from_jax(np_tree(jeng.backends[n].params),
                                  port_config(jv[n][0]), "cpu")
               for n in names}
    peng = PEngine({n: (port_config(c), a) for n, (c, a) in jv.items()},
                   mode=mode, device="cpu", weights=weights, **GEOMETRY)
    return names, jeng, peng


@pytest.mark.parametrize("mode", ["continuous", "pump"])
def test_engines_give_identical_outputs_on_the_mamba2_ladder(mode):
    jl = jladder("mamba2-130m")
    assert list(jl) == list(pladder("mamba2-130m"))
    jv = {n: jl[n] for n in list(jl)[:2]}          # depths 2 and 4
    names, jeng, peng = _engines(jv, mode)
    vocab = jv[names[0]][0].vocab_size
    want = _serve(jeng, _requests(JRequest, 7, 1, vocab), names)
    got = _serve(peng, _requests(PRequest, 7, 1, vocab), names)
    assert len(want) == 7 and got == want


def test_engines_give_identical_outputs_on_hymba_smoke():
    jcfg = _smoke("hymba-1.5b", d_model=128, name="hymba-smoke")
    names, jeng, peng = _engines({"hymba-smoke": (jcfg, 70.0)}, "continuous")
    want = _serve(jeng, _requests(JRequest, 5, 2, jcfg.vocab_size), names)
    got = _serve(peng, _requests(PRequest, 5, 2, jcfg.vocab_size), names)
    assert len(want) == 5 and got == want


def test_port_engine_refuses_paged_and_chunked_on_ssm():
    pv = {n: (c, a) for n, (c, a) in pladder("mamba2-130m").items()}
    name = next(iter(pv))
    eng = PEngine(pv, device="cpu", kv_cache="paged", **GEOMETRY)
    with pytest.raises(AssertionError, match="paged KV cache unsupported"):
        eng.apply_allocation(0.0, {name: 1})
    # chunked scheduling is ported, but an SSM has no prefill continuation:
    # the variant load refuses it, as the reference's backend asserts
    eng = PEngine(pv, device="cpu", scheduler="chunked", **GEOMETRY)
    with pytest.raises(AssertionError, match="prefill continuation"):
        eng.apply_allocation(0.0, {name: 1})
