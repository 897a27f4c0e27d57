"""The MoE family through the port's ``LM``, against the reference's.

The two config modules (granite-moe-3b-a800m, qwen3-moe-235b-a22b) equal
the reference's sources once ``repro_torch`` reads as ``repro``, and the
published configs build. Their smoke variants (4 experts, top 2, capacity
factor 16: dropless) run through the port's ``LM`` with the reference's
``LM.init`` weights (``bridge.params_from_jax``): ``apply`` (logits and
the layers' mean ``aux_loss``), prefill, decode against teacher forcing,
``prefill_chunk`` and ``verify_chunk`` on the dense cache, ``paged_admit``
+ ``decode_step_paged``, ``prefill_chunk_paged`` and
``verify_chunk_paged``, logits within 2e-4 absolute and 1e-4 relative
(fp32: sums in other orders), greedy tokens exactly equal; granite once
more with the kernels on (the reference's Pallas kernels in interpret
mode, the port's plain kernel versions) and once at capacity factor 1.0.
The engine's MoE cases are in ``test_torch_moe_engine.py``."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged_params, np_tree, port_config, to_np
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.launch.serve import build_ladder as jladder
from repro.models.model import build_model as jbuild
from repro_torch.bridge import expected_shapes, params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.serve import FULL_DEPTHS
from repro_torch.launch.serve import build_ladder as pladder
from repro_torch.models.model import LM

ROOT = Path(__file__).resolve().parents[1]
MOE = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
ATOL, RTOL = 2e-4, 1e-4
CACHE_ATOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# ------------------------------------------------------------ the configs
@pytest.mark.parametrize("module", ["granite_moe_3b_a800m",
                                    "qwen3_moe_235b_a22b"])
def test_copied_config_module_equals_reference(module):
    port = (ROOT / "src/repro_torch/configs" / f"{module}.py").read_text()
    ref = (ROOT / "src/repro/configs" / f"{module}.py").read_text()
    assert port.replace("repro_torch", "repro") == ref


@pytest.mark.parametrize("arch", MOE)
def test_the_published_moe_configs_build(arch):
    """``LM`` takes the published configs (no params drawn), and the
    bridge's tree names every expert tensor."""
    cfg = get_config(arch)
    lm = LM(cfg)
    assert lm.cfg.family == "moe" and lm.supports_paged_cache()
    L, D, E, F = (cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff)
    assert expected_shapes(cfg)["layers"]["ffn"] == {
        "router": (L, D, E), "wi": (L, E, D, F), "wg": (L, E, D, F),
        "wo": (L, E, F, D)}


def test_granite_full_width_ladder_ends_at_the_published_model():
    ladder = pladder("granite-moe-3b-a800m", full_width=True)
    assert FULL_DEPTHS["granite-moe-3b-a800m"] == (8, 16, 32)
    assert [c.num_layers for c, _ in ladder.values()] == [8, 16, 32]
    deepest = ladder["granite-moe-3b-a800m-L32"][0]
    assert deepest.replace(name="granite-moe-3b-a800m") == get_config(
        "granite-moe-3b-a800m")
    assert deepest.dtype == "bfloat16"
    assert deepest.param_count() == pytest.approx(3.38e9, rel=0.01)


def test_smoke_ladder_equals_reference():
    jl, pl = jladder("granite-moe-3b-a800m"), pladder("granite-moe-3b-a800m")
    assert list(jl) == list(pl)
    for n in jl:
        assert port_config(jl[n][0]) == pl[n][0] and jl[n][1] == pl[n][1]


# ------------------------------------------------------------ model level
MODEL_CFGS = [(a, jsmoke(jget(a))) for a in MOE] + [
    ("granite-kernels", jsmoke(jget(MOE[0])).replace(use_pallas=True)),
    ("granite-cf1", jsmoke(jget(MOE[0])).replace(moe_capacity_factor=1.0))]
MODEL_IDS = [n for n, _ in MODEL_CFGS]


@pytest.mark.parametrize("arch", MOE)
def test_bridge_carries_every_moe_leaf(arch):
    jcfg = jsmoke(jget(arch))
    jp, pp = bridged_params(jcfg)
    ffn = pp["layers"]["ffn"]
    assert set(ffn) == {"router", "wi", "wg", "wo"}
    assert ffn["router"].dtype == torch.float32
    for n in ffn:
        np.testing.assert_array_equal(
            to_np(ffn[n]), np.asarray(jp["layers"]["ffn"][n]))
    with pytest.raises(ValueError):      # a dense config's tree
        params_from_jax(np_tree(jp), port_config(jcfg).replace(
            family="dense"), "cpu")


@pytest.mark.parametrize("name,jcfg", MODEL_CFGS, ids=MODEL_IDS)
def test_moe_apply_matches_reference(name, jcfg):
    """Teacher forcing (the reference's smoke batch shape, 2 x 16): logits
    and the layers' mean load-balance loss."""
    jp, pp = bridged_params(jcfg)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 16))
    jl, jaux = jax.jit(lambda p, b: jbuild(jcfg).apply(p, b, train=False))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    pl, paux = LM(port_config(jcfg)).apply(
        pp, {"tokens": torch.as_tensor(toks)})
    assert pl.shape == (2, 16, jcfg.padded_vocab)
    assert bool(torch.isfinite(pl).all())
    _close(pl, jl)
    assert float(paux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(paux) >= 1.0 - 1e-3


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_teacher_forcing(arch):
    """The reference's consistency case on the port: prefill 9 tokens,
    then decode the next 3; each step's logits equal ``apply``'s at that
    position (the smoke variant is dropless, so the capacity of B·S and
    of B tokens route alike)."""
    jcfg = jsmoke(jget(arch))
    _, pp = bridged_params(jcfg)
    pm, S = LM(port_config(jcfg)), 12
    toks = torch.as_tensor(
        np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, S)))
    full, _ = pm.apply(pp, {"tokens": toks})
    lg, cache = pm.prefill(pp, {"tokens": toks[:, :S - 3]}, max_len=S)
    np.testing.assert_allclose(to_np(lg), to_np(full[:, S - 4]), atol=2e-3,
                               rtol=1e-3)
    for i in range(3):
        lg, cache = pm.decode_step(pp, cache, toks[:, S - 3 + i])
        np.testing.assert_allclose(to_np(lg), to_np(full[:, S - 3 + i]),
                                   atol=2e-3, rtol=1e-3)


def _assert_dense_cache(pc, jc, old, start, nv):
    """``pos`` equal; K/V a chunk wrote within CACHE_ATOL of the
    reference's; every other entry of the port's cache as it was."""
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    B, C = pc["k"].shape[1], pc["k"].shape[3]
    w = np.zeros((B, C), bool)
    for b in range(B):
        w[b, start[b]:start[b] + nv[b]] = True
    for n in ("k", "v"):                         # (L, B, KV, C, hd)
        got = to_np(pc[n]).transpose(1, 3, 0, 2, 4)
        want = np.asarray(jc[n]).transpose(1, 3, 0, 2, 4)
        np.testing.assert_allclose(got[w], want[w], atol=CACHE_ATOL)
        np.testing.assert_array_equal(got[~w],
                                      old[n].transpose(1, 3, 0, 2, 4)[~w])


@pytest.mark.parametrize("name,jcfg", MODEL_CFGS, ids=MODEL_IDS)
def test_moe_lm_matches_reference(name, jcfg):
    """Prefill (2 x 12 tokens into a cache of 24), 4 greedy decode steps,
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
    _close(pl, jl)
    jdecode = jax.jit(jm.decode_step)
    jseq, pseq = [], []
    for _ in range(4):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        pt = torch.argmax(pl, -1)
        jseq.append(np.asarray(jt))
        pseq.append(pt.numpy())
        jl, jc = jdecode(jp, jc, jt)
        pl, pc = pm.decode_step(pp, pc, pt)
        _close(pl, jl)
    np.testing.assert_array_equal(np.stack(pseq), np.stack(jseq))
    for n in ("k", "v"):
        np.testing.assert_allclose(to_np(pc[n]), np.asarray(jc[n]),
                                   atol=CACHE_ATOL)
    for method, start, nv in (("prefill_chunk", [S + 4, 0], [3, 0]),
                              ("verify_chunk", [S + 5, S + 4], [4, 2])):
        chunk = rng.integers(0, jcfg.vocab_size, (B, ck))
        start, nv = np.array(start), np.array(nv)
        old = {n: to_np(t) for n, t in pc.items()}
        jout, jc = jax.jit(getattr(jm, method))(
            jp, jc, jnp.asarray(chunk, jnp.int32),
            jnp.asarray(start, jnp.int32), jnp.asarray(nv, jnp.int32))
        pout, pc = getattr(pm, method)(
            pp, pc, torch.as_tensor(chunk), torch.as_tensor(start),
            torch.as_tensor(nv))
        if method == "prefill_chunk":           # logits of the active row
            _close(pout[:1], np.asarray(jout)[:1])
        else:                                   # argmax at valid positions
            for b in range(B):
                np.testing.assert_array_equal(pout.numpy()[b, :nv[b]],
                                              np.asarray(jout)[b, :nv[b]])
        _assert_dense_cache(pc, jc, old, start, nv)


@pytest.mark.parametrize("name,jcfg", MODEL_CFGS, ids=MODEL_IDS)
def test_moe_paged_lm_matches_reference(name, jcfg):
    """Prefill -> ``paged_admit`` into shuffled pages of 4 -> 4 greedy
    ``decode_step_paged`` steps -> a two-chunk ``prefill_chunk_paged``
    into a fresh slot -> ``verify_chunk_paged`` over both live rows:
    logits within tolerance, greedy tokens equal, tables, positions and
    every pool page but the port's trash page 0 equal."""
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
        _close(plog[dest], np.asarray(jlog)[dest])
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
        _close(plog[1:2], np.asarray(jlog)[1:2])
    # a verify chunk on the two admitted rows, rewound by one
    chunk = rng.integers(0, jcfg.vocab_size, (B, 3))
    start = np.asarray(jc["pos"]) - np.array([0, 0, 1])
    nv = np.array([3, 0, 3])
    jout, jc = jax.jit(jm.verify_chunk_paged)(
        jp, jc, jnp.asarray(chunk, jnp.int32), jnp.asarray(start, jnp.int32),
        jnp.asarray(nv, jnp.int32))
    pout, pc = pm.verify_chunk_paged(
        pp, pc, torch.as_tensor(chunk), torch.as_tensor(start),
        torch.as_tensor(nv))
    np.testing.assert_array_equal(pout.numpy()[[0, 2]],
                                  np.asarray(jout)[[0, 2]])
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(pc["pt"].numpy(), np.asarray(jc["pt"]))
    for n in ("kp", "vp"):                        # (L, KV, P, ps, hd)
        np.testing.assert_allclose(to_np(pc[n])[:, :, 1:],
                                   np.asarray(jc[n])[:, :, 1:],
                                   atol=CACHE_ATOL)


def test_moe_ranges_split_a_profiled_step():
    """The three profiler ranges of ``apply_moe`` appear once a layer
    under ``torch.profiler``, and ``profile_step.moe_split`` splits a
    region's device time by them (on the CPU no kernel has device time:
    every share is 0)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_step import moe_split
    jcfg = jsmoke(jget(MOE[0]))
    _, pp = bridged_params(jcfg)
    toks = torch.zeros((2, 4), dtype=torch.int64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        LM(port_config(jcfg)).prefill(pp, {"tokens": toks})
    ev = prof.key_averages()
    counts = {e.key: e.count for e in ev if e.key.startswith("moe.")}
    assert counts == {f"moe.{n}": jcfg.num_layers
                      for n in ("dispatch", "experts", "combine")}
    assert moe_split(ev, 5.0) == {"attention_ms": 0.0, "experts_ms": 0.0,
                                  "dispatch_ms": 0.0, "rest_ms": 5.0}
    assert moe_split([], 5.0) == {}
