"""The encoder-decoder family (whisper-tiny) through the port's ``LM``,
against the reference's, on the CPU.

Two configs: whisper-tiny's smoke variant (2 encoder and 2 decoder layers,
d_model 256, 32 frames) and a variant with 3 encoder layers over 2 decoder
layers and 24 frames, where mixing the two stacks' layer counts would show.
The cases (``_torch_multimodal``): the bridge carries every leaf;
``encode``; ``apply``; ``loss`` and every gradient; prefill + 3 decode
steps against the reference and against teacher forcing; kernels on (the
port's plain kernel versions) against the reference's Pallas path; train
steps at 1 and 2 microbatches; ``make_prefill_step``; checkpoints across
packages. fp32, logits within 2e-4 absolute and 1e-4 relative. Then the
config modules, the registry, and both packages' engines failing for
whisper-tiny at the same point (the engine feeds tokens only)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_multimodal as mm
from _torch_parity import bridged_params, port_config, to_np
from repro.configs import ALL_ARCHS as JALL
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.models.model import build_model as jbuild
from repro_torch import configs as pconfigs
from repro_torch.bridge import expected_shapes
from repro_torch.models.model import AUDIO_FRAME_DIM, LM

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
CFGS = {"smoke": jsmoke(jget(ARCH)),
        "enc3-dec2": jsmoke(jget(ARCH)).replace(
            enc_layers=3, enc_seq=24, name="whisper-tiny-enc3-smoke")}


@pytest.fixture(params=list(CFGS))
def jcfg(request):
    return CFGS[request.param]


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("module", ["whisper_tiny", "internvl2_26b"])
def test_copied_config_module_equals_reference(module):
    port = (ROOT / "src/repro_torch/configs" / f"{module}.py").read_text()
    ref = (ROOT / "src/repro/configs" / f"{module}.py").read_text()
    assert port.replace("repro_torch", "repro") == ref


def test_registry_equals_reference_and_every_config_builds():
    """The port's registry is the reference's, and ``LM`` takes every
    published config (no params drawn)."""
    assert pconfigs.ALL_ARCHS == JALL == sorted(pconfigs.REGISTRY)
    for arch in pconfigs.ALL_ARCHS:
        assert LM(pconfigs.get_config(arch)).cfg.name == arch


def test_published_whisper_tree():
    cfg = pconfigs.get_config(ARCH)
    t = expected_shapes(cfg)
    D, Le = cfg.d_model, cfg.enc_layers
    assert (t["enc_in"], t["enc_norm"]) == ((AUDIO_FRAME_DIM, D), (D,))
    assert t["enc_layers"]["attn"]["wq"] == (Le, D, 6 * 64)
    assert t["layers"]["xattn"]["wk"] == (cfg.num_layers, D, 6 * 64)
    assert t["layers"]["lnx"] == (cfg.num_layers, D)
    assert "vis_proj" not in t
    assert not LM(cfg).supports_paged_cache()


def test_init_tree_equals_the_reference(jcfg):
    """The port's own ``LM.init`` draws the reference's tree, key for key
    and shape for shape, the norms in the param dtype."""
    pp = LM(port_config(jcfg)).init(torch.Generator().manual_seed(0))
    jp = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    got = {tuple(k.key for k in p): tuple(v.shape) for p, v in
           jax.tree_util.tree_leaves_with_path(mm._port_as_jax_tree(pp))}
    want = {tuple(k.key for k in p): tuple(v.shape) for p, v in
            jax.tree_util.tree_leaves_with_path(jp)}
    assert got == want
    assert len(pp["enc_layers"]["ln1"]) == jcfg.enc_layers
    assert pp["layers"]["lnx"].dtype == torch.float32


# ------------------------------------------------------------ model level
def test_bridge_carries_every_leaf(jcfg):
    mm.bridge_case(jcfg)


def test_encode_matches_reference(jcfg):
    """The encoder's output over ``enc_seq`` frames, and over a shorter
    input (the sinusoid table is taken at the frames' own length)."""
    jp, pp = bridged_params(jcfg)
    for T in (jcfg.enc_seq, 7):
        frames = np.random.default_rng(T).standard_normal(
            (2, T, AUDIO_FRAME_DIM)).astype(np.float32)
        want = jax.jit(jbuild(jcfg).encode)(jp, jnp.asarray(frames))
        got = LM(port_config(jcfg)).encode(pp, torch.as_tensor(frames))
        assert got.shape == (2, T, jcfg.d_model)
        mm.close(got, want, 1e-5, 1e-5)


def test_apply_matches_reference(jcfg):
    mm.apply_case(jcfg)


def test_loss_and_every_gradient_match_reference(jcfg):
    mm.loss_case(jcfg)


def test_decode_matches_reference_and_teacher_forcing(jcfg):
    mm.decode_case(jcfg)


def test_kernels_on_match_reference_pallas(jcfg):
    mm.kernels_case(jcfg)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(microbatches):
    mm.train_step_case(CFGS["enc3-dec2"], microbatches)


def test_prefill_step_carries_frames():
    mm.prefill_step_case(CFGS["smoke"])


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_checkpoint_restores_across_packages(tmp_path, direction):
    mm.checkpoint_case(CFGS["enc3-dec2"], tmp_path, direction)


def test_cross_attention_recomputes_from_the_cached_encoder_output():
    """A decode step reads ``cache["enc"]``: zeroing it changes the step's
    logits, as the reference's (K and V are projected from it each step)."""
    jcfg = CFGS["smoke"]
    _, pp = bridged_params(jcfg)
    pm = LM(port_config(jcfg))
    _, pb = mm.batches(jcfg, S=6)
    _, c1 = pm.prefill(pp, pb, max_len=8)
    _, c2 = pm.prefill(pp, pb, max_len=8)
    c2["enc"] = torch.zeros_like(c2["enc"])
    tok = pb["tokens"][:, 0]
    l1, _ = pm.decode_step(pp, c1, tok)
    l2, _ = pm.decode_step(pp, c2, tok)
    assert float((l1 - l2).abs().max()) > 1e-3
    assert c1["enc"].shape == (2, jcfg.enc_seq, jcfg.d_model)
    np.testing.assert_array_equal(to_np(c1["pos"]), [7, 7])


# ------------------------------------------------------------ the engines
@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_both_engines_fail_for_whisper_at_the_same_point(kv_cache):
    """The engine feeds ``{"tokens": ...}`` only: the dense backend fails
    at its warm-up prefill on the missing ``frames`` (KeyError), the paged
    backend refuses the config (AssertionError), in both packages."""
    from repro.launch.serve import build_ladder as jladder
    from repro.serving.engine import InProcessServingEngine as JEngine
    from _torch_parity import port_variants
    from repro_torch.serving.engine import InProcessServingEngine as PEngine
    jv = {n: v for n, v in list(jladder(ARCH).items())[:1]}
    name = next(iter(jv))
    kw = dict(max_batch=2, prompt_len=8, max_new=4, decode_chunk=2,
              kv_cache=kv_cache)
    if kv_cache == "paged":
        kw["kv_page_size"] = 4
    want = mm.engine_failure(lambda: JEngine(jv, **kw), name)
    got = mm.engine_failure(
        lambda: PEngine(port_variants(jv), device="cpu", **kw), name)
    assert got[0] == want[0] == ("KeyError" if kv_cache == "dense"
                                 else "AssertionError")
    assert ("frames" in got[1]) == ("frames" in want[1]) == \
        (kv_cache == "dense")
    if kv_cache == "paged":
        assert "paged KV cache unsupported" in got[1]
        assert "paged KV cache unsupported" in want[1]
