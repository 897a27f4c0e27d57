"""The other dense configs in the port: gemma-2b, yi-6b and deepseek-67b.

Their config modules and ``configs/shapes.py`` equal the reference's
sources once ``repro_torch`` reads as ``repro``, and every registered
config's field dict equals the reference's. At model level the smoke
variants of the three (hd 64) and one gemma-shaped fp32 config at the
published head dim 256 (MQA, GeGLU, the tied embedding and gemma's
sqrt(d_model) embedding scale) run through the port's ``LM`` with the
reference's ``LM.init`` weights (``bridge.params_from_jax``): prefill and
decode logits within 1e-4 absolute (fp32: sums in other orders), caches
within 1e-5, greedy tokens exactly equal, and ``prefill_chunk``,
``verify_chunk``, ``paged_admit`` + ``decode_step_paged`` and
``prefill_chunk_paged`` equal to the reference's with every cache leaf
(entries a call must not touch compared exactly; the paged pools on every
page but the port's trash page 0). The hd-256 config runs with the
kernels off and on (the reference's Pallas kernels in interpret mode, the
port's plain kernel versions). The full-width ladders are checked by
their shapes and names alone."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged_params, np_tree, port_config, to_np
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.launch.serve import build_ladder as jladder
from repro.models.model import build_model as jbuild
from repro_torch import configs as pconfigs
from repro_torch.bridge import expected_shapes, params_from_jax
from repro_torch.launch.serve import FULL_DEPTHS
from repro_torch.launch.serve import build_ladder as pladder
from repro_torch.models.model import LM

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma-2b", "yi-6b", "deepseek-67b")
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


def gemma_hd256():
    """gemma-2b cut to a test size at its published head shape: 2 layers,
    d_model 512, 2 heads over one KV head of hd 256, GeGLU, the tied
    embedding, fp32; its name keeps gemma's embedding scale."""
    return jget("gemma-2b").replace(
        name="gemma-hd256-test", num_layers=2, d_model=512, num_heads=2,
        num_kv_heads=1, head_dim=256, d_ff=1024, vocab_size=512,
        dtype="float32", remat=False)


# ------------------------------------------------------------ the copies
@pytest.mark.parametrize("module", ["gemma_2b", "yi_6b", "deepseek_67b",
                                    "shapes"])
def test_copied_config_module_equals_reference(module):
    port = (ROOT / "src/repro_torch/configs" / f"{module}.py").read_text()
    ref = (ROOT / "src/repro/configs" / f"{module}.py").read_text()
    assert port.replace("repro_torch", "repro") == ref


def test_registry_holds_the_dense_configs():
    assert set(ARCHS) <= set(pconfigs.REGISTRY)
    assert set(pconfigs.REGISTRY) <= set(JREGISTRY)


@pytest.mark.parametrize("arch", sorted(pconfigs.REGISTRY))
def test_config_fields_equal_reference(arch):
    """Every field of the published config and of its smoke variant, with
    the reference's ``use_pallas`` read as ``use_kernels``."""
    for jcfg, pcfg in ((jget(arch), pconfigs.get_config(arch)),
                       (jsmoke(jget(arch)),
                        pconfigs.smoke_variant(pconfigs.get_config(arch)))):
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(
            port_config(jcfg))
        assert pcfg.param_count() == jcfg.param_count()


def test_shapes_and_pairs_equal_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import pairs as jpairs
    assert {n: dataclasses.asdict(s) for n, s in pconfigs.SHAPES.items()} \
        == {n: dataclasses.asdict(s) for n, s in JSHAPES.items()}
    names = sorted(pconfigs.REGISTRY)
    got = [(dataclasses.asdict(c), s.name, note) for c, s, note in
           pconfigs.pairs([pconfigs.get_config(n) for n in names])]
    want = [(dataclasses.asdict(port_config(c)), s.name, note) for c, s, note
            in jpairs([jget(n) for n in names])]
    assert got == want
    assert pconfigs.get_shape("decode_32k").seq_len == 32_768
    with pytest.raises(KeyError):
        pconfigs.get_shape("nope")
    cfg, note = pconfigs.adapt_config_for_shape(
        pconfigs.get_config("yi-6b"), pconfigs.get_shape("long_500k"))
    assert cfg.sliding_window == 8_192 and "sliding-window" in note


# ------------------------------------------------------------ the ladders
def test_smoke_ladders_equal_reference():
    for arch in ARCHS:
        jl, pl = jladder(arch), pladder(arch)
        assert list(jl) == list(pl)
        for n in jl:
            assert port_config(jl[n][0]) == pl[n][0]
            assert jl[n][1] == pl[n][1]


@pytest.mark.parametrize("full_width", [False, True])
def test_every_gemma_rung_keeps_the_embedding_scale(full_width):
    """The sqrt(d_model) embedding scale is keyed on the name (as in the
    reference), so every rung's name starts with ``gemma``; the rung's
    embedding is the scaled table row."""
    from repro_torch.models.layers import embed
    ladder = pladder("gemma-2b", full_width=full_width)
    assert all(n.startswith("gemma") and c.name == n
               for n, (c, _) in ladder.items())
    cfg = next(iter(ladder.values()))[0]
    table = torch.randn(8, cfg.d_model)
    x = embed(cfg, {"table": table}, torch.tensor([[3]]), torch.float32)
    torch.testing.assert_close(x[0, 0], table[3] * np.sqrt(cfg.d_model))


@pytest.mark.parametrize("arch,depths", [("gemma-2b", (6, 12, 18)),
                                         ("yi-6b", (8, 16, 32))])
def test_full_width_ladders_end_at_the_published_model(arch, depths):
    ladder = pladder(arch, full_width=True)
    assert FULL_DEPTHS[arch] == depths
    assert [c.num_layers for c, _ in ladder.values()] == list(depths)
    deepest = ladder[f"{arch}-L{depths[-1]}"][0]
    assert deepest.replace(name=arch) == pconfigs.get_config(arch)
    assert deepest.dtype == "bfloat16"


def test_deepseek_has_no_full_width_ladder():
    with pytest.raises(ValueError, match="no full-width ladder"):
        pladder("deepseek-67b", full_width=True)
    cut = pladder("deepseek-67b", depths=(2, 3), full_width=True)
    assert [c.num_layers for c, _ in cut.values()] == [2, 3]
    assert next(iter(cut.values()))[0].d_model == 8192


def test_gemma_tree_has_no_unembed_and_a_gate():
    shapes = expected_shapes(pconfigs.get_config("gemma-2b"))
    assert "unembed" not in shapes["embed"]
    assert shapes["embed"]["table"] == (256_000, 2048)
    assert shapes["layers"]["ffn"]["wg"] == (18, 2048, 16384)
    assert shapes["layers"]["attn"]["wk"] == (18, 2048, 256)


# ------------------------------------------------------------ model level
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}".lstrip("."))
    else:
        yield prefix, tree


MODEL_CFGS = [(a, jsmoke(jget(a))) for a in ARCHS] + [
    ("gemma-hd256", gemma_hd256()),
    ("gemma-hd256-kernels", gemma_hd256().replace(use_pallas=True))]
MODEL_IDS = [n for n, _ in MODEL_CFGS]


@pytest.mark.parametrize("name,jcfg", MODEL_CFGS[:4], ids=MODEL_IDS[:4])
def test_bridge_carries_every_leaf(name, jcfg):
    jp, pp = bridged_params(jcfg)
    jl, pl = dict(_leaves(np_tree(jp))), dict(_leaves(pp))
    assert set(jl) == set(pl)
    assert ("embed.unembed" in jl) == (not jcfg.tie_embeddings)
    assert ("layers.ffn.wg" in jl) == (jcfg.mlp_type in ("swiglu", "geglu"))
    for k, v in jl.items():
        np.testing.assert_array_equal(to_np(pl[k]), v)
    with pytest.raises(ValueError):      # the tree of another config
        params_from_jax(np_tree(jp), port_config(jcfg).replace(
            tie_embeddings=not jcfg.tie_embeddings), "cpu")


def _written(B, C, start, nv):
    w = np.zeros((B, C), bool)
    for b in range(B):
        w[b, start[b]:start[b] + nv[b]] = True
    return w


def _assert_dense_cache(pc, jc, old, start, nv):
    """``pos`` equal; written K/V within CACHE_ATOL of the reference's; the
    rest of the port's cache as it was (``old``)."""
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    B, C = pc["k"].shape[1], pc["k"].shape[3]
    w = _written(B, C, start, nv)
    for n in ("k", "v"):                         # (L, B, KV, C, hd)
        got = to_np(pc[n]).transpose(1, 3, 0, 2, 4)
        want = np.asarray(jc[n]).transpose(1, 3, 0, 2, 4)
        np.testing.assert_allclose(got[w], want[w], atol=CACHE_ATOL)
        np.testing.assert_array_equal(got[~w],
                                      old[n].transpose(1, 3, 0, 2, 4)[~w])


@pytest.mark.parametrize("name,jcfg", MODEL_CFGS, ids=MODEL_IDS)
def test_dense_lm_matches_reference(name, jcfg):
    """Prefill (2 x 12 tokens into a ring of 24), 4 greedy decode steps,
    one prefill-continuation chunk (row 0 at its position, row 1 inert)
    and one verify chunk (row 0 rewound by 2, row 1 at its position)."""
    jp, pp = bridged_params(jcfg)
    jm, pm = jbuild(jcfg), LM(port_config(jcfg))
    rng = np.random.default_rng(3)
    B, S, C, ck = 2, 12, 24, 4
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=C)
    pl, pc = pm.prefill(pp, {"tokens": torch.as_tensor(toks)}, max_len=C)
    np.testing.assert_allclose(to_np(pl), np.asarray(jl), atol=LOGIT_ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(to_np(pc[n]), np.asarray(jc[n]),
                                   atol=CACHE_ATOL)
    jdecode = jax.jit(jm.decode_step)
    jseq, pseq = [], []
    for _ in range(4):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        pt = torch.argmax(pl, -1)
        jseq.append(np.asarray(jt))
        pseq.append(pt.numpy())
        jl, jc = jdecode(jp, jc, jt)
        pl, pc = pm.decode_step(pp, pc, pt)
        np.testing.assert_allclose(to_np(pl), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    np.testing.assert_array_equal(np.stack(pseq), np.stack(jseq))
    for n in ("k", "v"):
        np.testing.assert_allclose(to_np(pc[n]), np.asarray(jc[n]),
                                   atol=CACHE_ATOL)
    # a prefill continuation chunk, then a verify chunk
    for method, start, nv in (("prefill_chunk", [S + 4, 0], [3, 0]),
                              ("verify_chunk", [S + 5, S + 4], [4, 2])):
        chunk = rng.integers(0, jcfg.vocab_size, (B, ck))
        start, nv = np.array(start), np.array(nv)
        old = {n: to_np(t) for n, t in pc.items()}  # the port's, in place
        jout, jc = jax.jit(getattr(jm, method))(
            jp, jc, jnp.asarray(chunk, jnp.int32),
            jnp.asarray(start, jnp.int32), jnp.asarray(nv, jnp.int32))
        pout, pc = getattr(pm, method)(
            pp, pc, torch.as_tensor(chunk), torch.as_tensor(start),
            torch.as_tensor(nv))
        if method == "prefill_chunk":           # logits of the active row
            np.testing.assert_allclose(to_np(pout)[0], np.asarray(jout)[0],
                                       atol=LOGIT_ATOL)
        else:                                   # argmax at valid positions
            for b in range(B):
                np.testing.assert_array_equal(pout.numpy()[b, :nv[b]],
                                              np.asarray(jout)[b, :nv[b]])
        _assert_dense_cache(pc, jc, old, start, nv)


@pytest.mark.parametrize("name,jcfg", MODEL_CFGS, ids=MODEL_IDS)
def test_paged_lm_matches_reference(name, jcfg):
    """Prefill -> ``paged_admit`` into shuffled pages of 4 -> 4 greedy
    ``decode_step_paged`` steps -> a two-chunk ``prefill_chunk_paged``
    into a fresh slot: logits within LOGIT_ATOL, greedy tokens equal,
    tables, positions and every pool page but the trash page equal."""
    jp, pp = bridged_params(jcfg)
    jm, pm = jbuild(jcfg), LM(port_config(jcfg))
    rng = np.random.default_rng(5)
    B, S, ps, per = 3, 8, 4, 4
    P = B * per + 1
    toks = rng.integers(0, jcfg.vocab_size, (2, S))
    page_ids = 1 + rng.permutation(2 * per).reshape(2, per)
    dest = np.array([2, 0])
    jl, jpre = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=S)
    pl, ppre = pm.prefill(pp, {"tokens": torch.as_tensor(toks)}, max_len=S)
    jc, jtok = jax.jit(jm.paged_admit)(
        jm.init_paged_cache(B, P, ps, per), jpre, jnp.zeros((B,), jnp.int32),
        jnp.argmax(jl, -1).astype(jnp.int32),
        jnp.asarray(page_ids, jnp.int32), jnp.asarray(dest, jnp.int32))
    pc, ptok = pm.paged_admit(
        pm.init_paged_cache(B, P, ps, per, torch.device("cpu")), ppre,
        torch.zeros(B, dtype=torch.int64), torch.argmax(pl, -1),
        torch.as_tensor(page_ids), torch.as_tensor(dest))
    jdecode = jax.jit(jm.decode_step_paged, static_argnames="n_pages")
    jseq, pseq = [], []
    for _ in range(4):
        jlog, jc = jdecode(jp, jc, jtok, n_pages=per)
        plog, pc = pm.decode_step_paged(pp, pc, ptok, n_pages=per)
        np.testing.assert_allclose(to_np(plog)[dest], np.asarray(jlog)[dest],
                                   atol=LOGIT_ATOL)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ptok = torch.argmax(plog, -1)
        jseq.append(np.asarray(jtok)[dest])
        pseq.append(ptok.numpy()[dest])
    np.testing.assert_array_equal(np.stack(pseq), np.stack(jseq))
    free = [p for p in range(1, P) if p not in page_ids][:per]
    jc["pt"] = jc["pt"].at[1].set(jnp.asarray(free, jnp.int32))
    pc["pt"][1] = torch.as_tensor(free, dtype=torch.int32)
    seq = rng.integers(0, jcfg.vocab_size, 7)
    jchunk = jax.jit(jm.prefill_chunk_paged)
    for lo, hi in ((0, 4), (4, 7)):
        chunk = np.zeros((B, 4), np.int64)
        chunk[1, :hi - lo] = seq[lo:hi]
        start, nv = np.array([0, lo, 0]), np.array([0, hi - lo, 0])
        jlog, jc = jchunk(jp, jc, jnp.asarray(chunk, jnp.int32),
                          jnp.asarray(start, jnp.int32),
                          jnp.asarray(nv, jnp.int32))
        plog, pc = pm.prefill_chunk_paged(
            pp, pc, torch.as_tensor(chunk), torch.as_tensor(start),
            torch.as_tensor(nv))
        np.testing.assert_allclose(to_np(plog)[1], np.asarray(jlog)[1],
                                   atol=LOGIT_ATOL)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(pc["pt"].numpy(), np.asarray(jc["pt"]))
    for n in ("kp", "vp"):                        # (L, KV, P, ps, hd)
        np.testing.assert_allclose(to_np(pc[n])[:, :, 1:],
                                   np.asarray(jc[n])[:, :, 1:],
                                   atol=CACHE_ATOL)
