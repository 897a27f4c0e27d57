"""The port's dense ``LM`` against ``repro.models.model.LM`` with bridged
weights: prefill logits and caches, decode logits, teacher-forced logits
(fp32, tolerance 1e-4 absolute on logits, 1e-5 on caches) and identical
8-token greedy continuations; plus the weight bridge itself."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_variants

from _torch_parity import (bridged_params, np_tree, port_config,
                          reference_init, to_np)
from repro.launch.serve import build_ladder as jladder
from repro.models.model import build_model as jbuild
from repro_torch.bridge import expected_shapes, params_from_jax
from repro_torch.launch.serve import build_ladder as pladder
from repro_torch.models.model import LM, build_model

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


def _ladder_cfgs():
    """(id, reference config) over the tiny and smoke ladders plus a
    sliding-window variant (ring cache smaller than the sequence)."""
    out = [(n, c) for n, (c, _) in tiny_variants(1).items()]
    ladder = jladder("tinyllama-1.1b")          # its shallowest and deepest
    out += [(n, ladder[n][0]) for n in (min(ladder), max(ladder))]
    small = tiny_variants(1)["small"][0]
    out.append(("window", small.replace(sliding_window=8, name="window")))
    out.append(("kernels", small.replace(use_pallas=True, name="kernels")))
    return out


CFGS = _ladder_cfgs()
IDS = [n for n, _ in CFGS]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}".lstrip("."))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name,jcfg", CFGS, ids=IDS)
def test_bridge_carries_every_leaf(name, jcfg):
    jp = np_tree(reference_init(jcfg))
    pp = params_from_jax(jp, port_config(jcfg), "cpu")
    jl, pl = dict(_leaves(jp)), dict(_leaves(pp))
    assert set(jl) == set(pl)
    for k, v in jl.items():
        assert tuple(pl[k].shape) == v.shape, k
        np.testing.assert_array_equal(to_np(pl[k]), v)
        # a copy, not a view of the reference's buffer
        assert pl[k].data_ptr() != v.ctypes.data


def test_bridge_copies():
    jcfg = tiny_variants(1)["small"][0]
    jp = np_tree(reference_init(jcfg))
    pp = params_from_jax(jp, port_config(jcfg), "cpu")
    before = to_np(pp["layers"]["attn"]["wq"]).copy()
    jp["layers"]["attn"]["wq"][...] = 0.0
    np.testing.assert_array_equal(to_np(pp["layers"]["attn"]["wq"]), before)


@pytest.mark.parametrize("mutate", ["missing", "extra", "shape"])
def test_bridge_rejects_mismatched_trees(mutate):
    jcfg = tiny_variants(1)["small"][0]
    jp = np_tree(reference_init(jcfg))
    if mutate == "missing":
        del jp["layers"]["ffn"]["wg"]
    elif mutate == "extra":
        jp["layers"]["attn"]["bq"] = np.zeros(3)
    else:
        jp["final_norm"] = np.zeros(7)
    with pytest.raises(ValueError):
        params_from_jax(jp, port_config(jcfg), "cpu")


def test_bridge_places_weights_in_the_requested_dtype():
    jcfg = tiny_variants(1)["small"][0]
    jp = np_tree(reference_init(jcfg))
    pp = params_from_jax(jp, port_config(jcfg), "cpu", dtype=torch.bfloat16)
    assert pp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert pp["layers"]["ln1"].dtype == torch.float32     # norms stay fp32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_init_has_the_reference_leaves(dtype):
    jcfg = tiny_variants(1)["small"][0].replace(dtype=dtype)
    pc = port_config(jcfg)
    pp = LM(pc).init(torch.Generator().manual_seed(0))
    jp = np_tree(reference_init(jcfg))
    shapes = dict(_leaves(expected_shapes(pc)))
    assert shapes == {k: v.shape for k, v in _leaves(jp)}
    for k, t in _leaves(pp):
        assert tuple(t.shape) == shapes[k]
        norm = k.split(".")[-1] in ("ln1", "ln2", "final_norm")
        assert t.dtype == (torch.float32 if norm else getattr(torch, dtype))


def _jitted(jcfg):
    """The reference's prefill/decode, jitted (eager JAX dispatch would
    dominate these tests' time)."""
    jm = jbuild(jcfg)
    return (jax.jit(jm.prefill, static_argnames=("max_len",)),
            jax.jit(jm.decode_step))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("name,jcfg", CFGS, ids=IDS)
@pytest.mark.parametrize("S,max_len", [(12, 20), (16, 10)])  # 2nd: S >= C
def test_prefill_and_decode_match(name, jcfg, S, max_len):
    jp, pp = bridged_params(jcfg)
    (jprefill, jdecode), pm = _jitted(jcfg), build_model(port_config(jcfg))
    toks = _tokens(jcfg, 2, S, seed=S)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    pl, pc = pm.prefill(pp, {"tokens": torch.as_tensor(toks)},
                        max_len=max_len)
    np.testing.assert_allclose(to_np(pl), np.asarray(jl), atol=LOGIT_ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(pc[key]), np.asarray(jc[key]),
                                   atol=CACHE_ATOL)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    tok = np.array(jnp.argmax(jl, -1))
    for _ in range(3):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok, jnp.int32))
        pl, pc = pm.decode_step(pp, pc, torch.as_tensor(tok))
        np.testing.assert_allclose(to_np(pl), np.asarray(jl), atol=LOGIT_ATOL)
        tok = np.array(jnp.argmax(jl, -1))
    np.testing.assert_allclose(to_np(pc["k"]), np.asarray(jc["k"]),
                               atol=CACHE_ATOL)


@pytest.mark.parametrize("name,jcfg", CFGS, ids=IDS)
def test_greedy_continuation_identical(name, jcfg):
    jp, pp = bridged_params(jcfg, seed=1)
    (jprefill, jdecode), pm = _jitted(jcfg), build_model(port_config(jcfg))
    toks = _tokens(jcfg, 3, 10, seed=5)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, max_len=18)
    pl, pc = pm.prefill(pp, {"tokens": torch.as_tensor(toks)}, max_len=18)
    jseq, pseq = [], []
    for _ in range(8):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        pt = torch.argmax(pl, dim=-1)
        jseq.append(np.asarray(jt))
        pseq.append(pt.numpy())
        jl, jc = jdecode(jp, jc, jt)
        pl, pc = pm.decode_step(pp, pc, pt)
    np.testing.assert_array_equal(np.stack(pseq), np.stack(jseq))


@pytest.mark.parametrize("name,jcfg", CFGS[:3], ids=IDS[:3])
def test_apply_matches(name, jcfg):
    jp, pp = bridged_params(jcfg)
    toks = _tokens(jcfg, 2, 9, seed=3)
    want, _ = jbuild(jcfg).apply(jp, {"tokens": jnp.asarray(toks)})
    got, _ = build_model(port_config(jcfg)).apply(
        pp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=LOGIT_ATOL)


def test_smoke_ladder_matches_reference():
    jl, pl = jladder("tinyllama-1.1b"), pladder("tinyllama-1.1b")
    assert list(jl) == list(pl)
    for n in jl:
        assert port_config(jl[n][0]) == pl[n][0]
        assert jl[n][1] == pl[n][1]


def test_full_width_ladder_is_published_tinyllama():
    ladder = pladder("tinyllama-1.1b", full_width=True)
    assert [c.num_layers for c, _ in ladder.values()] == [8, 15, 22]
    assert [a for _, a in ladder.values()] == [70.0, 75.0, 78.0]
    c = ladder["tinyllama-1.1b-L22"][0]
    assert (c.d_model, c.num_heads, c.num_kv_heads, c.resolved_head_dim,
            c.d_ff, c.vocab_size, c.rope_theta, c.mlp_type, c.dtype) == \
        (2048, 32, 4, 64, 5632, 32000, 10_000.0, "swiglu", "bfloat16")


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_unported_families_raise(family):
    cfg = port_config(tiny_variants(1)["small"][0]).replace(family=family)
    with pytest.raises(NotImplementedError):
        LM(cfg)
