"""The VLM family (internvl2-26b) through the port's ``LM`` and engine,
against the reference's, on the CPU.

Model level, on internvl2-26b's smoke variant (2 layers, d_model 256, 4
query heads on 4 KV heads of hd 64, an 8-patch image prefix) with the
reference's weights (``_torch_multimodal``): the bridge carries every leaf
(``vis_proj`` among them); ``apply`` with the image prefix and text-only;
``loss`` and every gradient (the prefix's logits dropped); prefill + 3
decode steps after the prefix against the reference and against teacher
forcing; kernels on against the reference's Pallas path; train steps at 1
and 2 microbatches; ``make_prefill_step``; checkpoints across packages;
then text-only, as the engine serves it, ``prefill_chunk``,
``verify_chunk`` and the paged admit, decode, chunk and verify forms (the
MoE model test's cases). fp32, logits within 2e-4 absolute and 1e-4
relative, greedy tokens equal. Engine level: the text-only smoke ladder
(2/4/6 layers at d_model 128) on one staggered workload, dense FIFO, paged
with prefix sharing and ``chunked``, port engine = reference engine."""
import pytest

import _torch_multimodal as mm
import test_torch_moe_model as lm_cases
from _torch_parity import (outcome, port_config, port_variants,
                           reference_weights, serve_staggered)
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.launch.serve import build_ladder as jladder
from repro.serving.api import Request as JRequest
from repro.serving.engine import InProcessServingEngine as JEngine
from repro_torch.bridge import expected_shapes
from repro_torch.configs import get_config
from repro_torch.launch.serve import FULL_DEPTHS
from repro_torch.launch.serve import build_ladder as pladder
from repro_torch.models.model import VISION_EMBED_DIM, LM
from repro_torch.serving.api import Request as PRequest
from repro_torch.serving.engine import InProcessServingEngine as PEngine

ARCH = "internvl2-26b"
JCFG = jsmoke(jget(ARCH))


# ------------------------------------------------------------ the config
def test_published_internvl_tree_and_ladder():
    """The published config's tree has ``vis_proj`` (1024, D) and no
    encoder; the full-width ladder is 8/16/48 layers, the deepest the
    published model (~25.9 B parameters, 63 GB of bf16 weights over the
    three rungs)."""
    cfg = get_config(ARCH)
    t = expected_shapes(cfg)
    assert t["vis_proj"] == (VISION_EMBED_DIM, cfg.d_model)
    assert "enc_layers" not in t and "xattn" not in t["layers"]
    lm = LM(cfg)
    assert lm.supports_paged_cache() and lm.supports_chunked_prefill()
    ladder = pladder(ARCH, full_width=True)
    assert FULL_DEPTHS[ARCH] == (8, 16, 48)
    assert [c.num_layers for c, _ in ladder.values()] == [8, 16, 48]
    deepest = ladder[f"{ARCH}-L48"][0]
    assert deepest.replace(name=ARCH) == cfg and deepest.dtype == "bfloat16"
    total = sum(c.param_count() for c, _ in ladder.values())
    assert 2 * total == pytest.approx(63e9, rel=0.02)


def test_smoke_ladder_equals_reference():
    jl, pl = jladder(ARCH), pladder(ARCH)
    assert list(jl) == list(pl)
    for n in jl:
        assert port_config(jl[n][0]) == pl[n][0] and jl[n][1] == pl[n][1]


# ------------------------------------------------------------ model level
def test_bridge_carries_every_leaf():
    mm.bridge_case(JCFG)


@pytest.mark.parametrize("text_only", [False, True],
                         ids=["image-prefix", "text-only"])
def test_apply_matches_reference(text_only):
    logits = mm.apply_case(JCFG, text_only=text_only)
    assert logits.shape[1] == 12 + (0 if text_only
                                    else JCFG.num_frontend_tokens)


def test_loss_and_every_gradient_match_reference():
    mm.loss_case(JCFG)


def test_decode_matches_reference_and_teacher_forcing():
    mm.decode_case(JCFG)


def test_kernels_on_match_reference_pallas():
    mm.kernels_case(JCFG)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(microbatches):
    mm.train_step_case(JCFG, microbatches)


def test_prefill_step_carries_patch_embeds():
    mm.prefill_step_case(JCFG)


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_checkpoint_restores_across_packages(tmp_path, direction):
    mm.checkpoint_case(JCFG, tmp_path, direction)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_text_only_chunk_and_verify_match_reference(kernels):
    lm_cases.test_moe_lm_matches_reference(
        ARCH, JCFG.replace(use_pallas=kernels))


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_text_only_paged_forms_match_reference(kernels):
    lm_cases.test_moe_paged_lm_matches_reference(
        ARCH, JCFG.replace(use_pallas=kernels))


# ------------------------------------------------------------ the engine
GEOMETRY = dict(max_batch=2, prompt_len=8, max_new=6, decode_chunk=2,
                kv_page_size=4, prefill_chunk=4)
VOCAB = 512                         # the smoke variant's vocabulary


def _engine(cls, jv, **kw):
    t = [0.0]
    kw = {**GEOMETRY, **kw, "clock": lambda: t[0]}
    if cls is JEngine:
        eng = JEngine(jv, **kw)
    else:
        eng = PEngine(port_variants(jv), device="cpu",
                      weights=reference_weights(jv), **kw)
    eng.t = t
    eng.apply_allocation(0.0, {n: 1 for n in jv})
    return eng


@pytest.mark.parametrize("label,kw,sharing", [
    ("dense-fifo", {}, False),
    ("paged-sharing", dict(kv_cache="paged", kv_prefix_sharing=True), True),
    ("dense-chunked", dict(scheduler="chunked"), False)])
def test_internvl_smoke_ladder_matches_reference_engine(label, kw, sharing):
    """Text-only requests (the engine feeds tokens, as the reference's):
    every request on the same rung with the same greedy tokens, equal
    summaries (and pool statistics with sharing)."""
    jv = jladder(ARCH)
    assert list(jv) == [f"{ARCH}-L{d}" for d in (2, 4, 6)]
    assert jv[f"{ARCH}-L2"][0].family == "vlm"
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


def test_init_draws_layers_into_stacks_allocated_up_front():
    """``LM.init`` copies each drawn layer into stacks allocated before
    the draws (one layer alive beside the stacks: internvl2-26b's 48 layers
    are 37 GB in bf16, and a stack of a list held them twice), with the
    draws of a list stacked afterwards, in the same order."""
    import torch
    from repro_torch.models import model as pmodel
    cfg = port_config(JCFG)
    lm = LM(cfg)
    got = lm.init(torch.Generator().manual_seed(5))["layers"]
    gen = torch.Generator().manual_seed(5)
    from repro_torch.models.layers import init_embed
    init_embed(gen, cfg, lm.compute_dtype, torch.device("cpu"))
    layers = [lm._init_layer(gen, torch.device("cpu"), lm.compute_dtype)
              for _ in range(cfg.num_layers)]
    assert torch.equal(got["attn"]["wq"],
                       torch.stack([p["attn"]["wq"] for p in layers]))
    assert torch.equal(got["ffn"]["wo"],
                       torch.stack([p["ffn"]["wo"] for p in layers]))
    order = []

    def draw():
        order.append(len(order))
        return {"w": torch.full((2, 3), float(order[-1]))}

    stacked = pmodel._draw_stacked(3, draw)
    assert order == [0, 1, 2]
    assert torch.equal(stacked["w"][:, 0, 0], torch.tensor([0.0, 1.0, 2.0]))
