"""The port's training path against the reference's, on the CPU.

Mirrors of ``tests/test_train.py`` (Adam on a quadratic, the pre-clip
norm, warmup, microbatches = full batch, the token pipeline) and of
``tests/test_configs_smoke.py::test_smoke_train_step``; then parity with
the reference on one state: ``adam_update`` over 5 steps (cosine and
constant schedules, weight decay 0 / 0.1, clip 0 / 1: params, ``mu``,
``nu``, ``lr`` and ``grad_norm`` within 1e-6 absolute); the token
pipeline's batches equal for 3 seeds x 3 calls; ``LM.loss`` and every
gradient leaf against ``jax.value_and_grad`` of the reference's loss for
each ported family's smoke config in fp32 (loss within 1e-5 relative, each
leaf's max-abs difference <= 1e-4 of its max-abs: sums in other orders);
label -1 masked; remat on = off bitwise; three ``make_train_step`` steps
against the reference's with 1 and 2 microbatches (params within 1e-5,
losses within 1e-5 relative). Weights come from the reference's
``LM.init`` through ``bridge.params_from_jax``, inputs from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged_params, port_config, to_np
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.data.tokens import SyntheticTokenPipeline as JPipeline
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.model import build_model as jbuild
from repro.train import optimizer as jopt
from repro_torch.bridge import adam_state_from_jax
from repro_torch.data.tokens import SyntheticTokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import LM
from repro_torch.train.optimizer import (AdamConfig, adam_init, adam_update,
                                         global_norm, tree_leaves,
                                         tree_unflatten, value_and_grad)

PORTED = ("tinyllama-1.1b", "gemma-2b", "yi-6b", "deepseek-67b",
          "granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "mamba2-130m",
          "hymba-1.5b")
MULTIMODAL = ("whisper-tiny", "internvl2-26b")  # frames / patch_embeds
ADAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_ATOL = 1e-5


def _batch(vocab, B=2, S=16, seed=7, masked=0):
    """Tokens from a numpy seed, labels shifted by one (the reference
    smoke test's ``jnp.roll``), the first ``masked`` labels of row 0 -1."""
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    labels = np.roll(toks, -1, axis=1)
    labels[0, :masked] = -1
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)})


def _tiny(**overrides):
    """The reference's microbatch test config, with ``overrides``."""
    kw = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, remat=False)
    return jsmoke(jget("tinyllama-1.1b")).replace(**{**kw, **overrides})


# ------------------------------------------------- tests/test_train.py
def test_adam_converges_quadratic():
    cfg = AdamConfig(lr=0.1, warmup_steps=0, schedule="constant", grad_clip=0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adam_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adam_update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip():
    cfg = AdamConfig(lr=0.0, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    state = adam_init(params)
    _, _, m = adam_update(cfg, {"w": torch.full((3,), 100.0)}, state, params)
    assert float(m["grad_norm"]) > 100.0  # reported pre-clip


def test_warmup_schedule():
    cfg = AdamConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    params = {"w": torch.ones(2)}
    state = adam_init(params)
    _, state, m1 = adam_update(cfg, {"w": torch.ones(2)}, state, params)
    assert float(m1["lr"]) < 1e-3 * 0.2  # still warming up


def test_microbatched_train_step_matches_full_batch():
    """Gradient accumulation must equal the full-batch gradient step."""
    jcfg = _tiny()
    _, params = bridged_params(jcfg)
    opt = adam_init(params)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (4, 16)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    cfg = port_config(jcfg)
    p1, _, m1 = make_train_step(cfg, microbatches=1)(params, opt, batch)
    p2, _, m2 = make_train_step(cfg, microbatches=2)(params, opt, batch)
    err = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert err < 1e-5
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4


def test_data_pipeline_learnable():
    pipe = SyntheticTokenPipeline(vocab=64, seq_len=32, batch=4, branching=4,
                                  device="cpu")
    b = pipe.next_batch()
    assert b["tokens"].shape == (4, 32)
    assert b["labels"].shape == (4, 32)
    # labels are the next tokens
    assert bool(torch.all(b["tokens"][:, 1:] == b["labels"][:, :-1]))


# ------------------------------------------------- Adam against the reference
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adam_update_matches_reference(schedule, weight_decay, grad_clip):
    """5 steps from one state (the reference's ``adam_init`` carried over
    by ``bridge.adam_state_from_jax``) on the same gradients; warmup 2 of
    6 total steps, so the schedule's warmup, its decay and its end all
    run. Gradients of norm ~10 make the clip bind."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule,
              weight_decay=weight_decay, grad_clip=grad_clip)
    jcfg, pcfg = jopt.AdamConfig(**kw), AdamConfig(**kw)
    rng = np.random.default_rng(11)
    p0 = {"a": rng.standard_normal((6, 5)).astype(np.float32),
          "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.adam_init(jp)
    pp = {"a": torch.tensor(p0["a"]), "b": {"c": torch.tensor(p0["b"]["c"])}}
    ps = adam_state_from_jax(js, "cpu")
    for _ in range(5):
        g = {"a": 3 * rng.standard_normal((6, 5)).astype(np.float32),
             "b": {"c": rng.standard_normal(7).astype(np.float32)}}
        jp, js, jm = jopt.adam_update(
            jcfg, jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        pp, ps, pm = adam_update(
            pcfg, {"a": torch.tensor(g["a"]),
                   "b": {"c": torch.tensor(g["b"]["c"])}}, ps, pp)
        assert int(ps.step) == int(js.step)
        for want, got in ((jp, pp), (js.mu, ps.mu), (js.nu, ps.nu)):
            for a, b in zip(jax.tree_util.tree_leaves(want),
                            tree_leaves(got)):
                np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=0,
                                           atol=ADAM_ATOL)
        for k in ("lr", "grad_norm"):
            assert abs(float(pm[k]) - float(jm[k])) <= ADAM_ATOL * max(
                1.0, abs(float(jm[k]))), k


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = {"x": rng.standard_normal((9, 4)).astype(np.float32),
            "y": [rng.standard_normal(3).astype(np.float32)]}
    want = float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = float(global_norm({"x": torch.tensor(tree["x"]),
                             "y": [torch.tensor(tree["y"][0])]}))
    assert abs(got - want) <= 1e-6 * want


# ------------------------------------------------- the token pipeline
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_token_pipeline_batches_equal_reference(seed):
    ref = JPipeline(vocab=97, seq_len=24, batch=3, seed=seed, branching=5)
    port = SyntheticTokenPipeline(vocab=97, seq_len=24, batch=3, seed=seed,
                                  branching=5, device="cpu")
    for _ in range(3):
        want, got = ref.next_batch(), port.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------- LM.loss and its gradients
def _ref_loss_and_grads(jcfg, jp, jbatch):
    m = jbuild(jcfg)
    return jax.jit(jax.value_and_grad(lambda p: m.loss(p, jbatch),
                                      has_aux=True))(jp)


@pytest.mark.parametrize("arch", PORTED)
def test_loss_and_every_gradient_match_reference(arch):
    """fp32 smoke config; 3 masked labels in row 0."""
    jcfg = jsmoke(jget(arch))
    jp, pp = bridged_params(jcfg)
    jbatch, pbatch = _batch(jcfg.vocab_size, masked=3)
    (jl, jm), jg = _ref_loss_and_grads(jcfg, jp, jbatch)
    (pl, pm), pg = value_and_grad(LM(port_config(jcfg)).loss, pp, pbatch)
    assert abs(float(pl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for k in ("ce_loss", "aux_loss"):
        assert abs(float(pm[k]) - float(jm[k])) <= LOSS_RTOL * max(
            abs(float(jm[k])), 1e-3), k
    if jcfg.is_moe:
        assert float(pm["aux_loss"]) > 0.0
    want, got = jax.tree_util.tree_leaves(jg), tree_leaves(pg)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == torch.float32
        assert np.abs(to_np(b) - a).max() <= GRAD_REL * np.abs(a).max()


def test_masked_labels_leave_the_loss():
    """A label of -1 drops its position: the loss is the mean of the
    other positions' NLL, and a batch with every label masked has loss 0
    (the reference's ``max(sum(mask), 1)``)."""
    jcfg = _tiny()
    _, pp = bridged_params(jcfg)
    lm = LM(port_config(jcfg))
    _, batch = _batch(64, masked=5)
    loss, _ = lm.loss(pp, batch)
    logits, _ = lm.apply(pp, batch)
    logp = torch.log_softmax(logits.float(), -1)
    keep = batch["labels"] >= 0
    nll = -torch.gather(logp, -1, batch["labels"].clamp(min=0)[..., None])
    assert torch.allclose(loss, nll[..., 0][keep].mean(), rtol=1e-6)
    assert not torch.allclose(loss, nll.mean(), rtol=1e-6)
    none = dict(batch, labels=torch.full_like(batch["labels"], -1))
    assert float(lm.loss(pp, none)[0]) == 0.0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m",
                                  "hymba-1.5b"])
def test_remat_on_equals_off_bitwise(arch):
    """Checkpointed layers recompute the same ops on the same inputs: the
    loss and every gradient are bitwise those of the plain run."""
    jcfg = jsmoke(jget(arch))
    _, pp = bridged_params(jcfg)
    _, batch = _batch(jcfg.vocab_size, masked=2)
    (l0, m0), g0 = value_and_grad(
        LM(port_config(jcfg, remat=False)).loss, pp, batch)
    (l1, m1), g1 = value_and_grad(
        LM(port_config(jcfg, remat=True)).loss, pp, batch)
    assert torch.equal(l0, l1) and torch.equal(m0["aux_loss"],
                                               m1["aux_loss"])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_keeps_only_layer_inputs():
    """With remat each layer's activations are freed after the forward
    pass: the autograd graph of a remat loss saves fewer bytes."""
    jcfg = _tiny(num_layers=3)
    _, pp = bridged_params(jcfg)
    _, batch = _batch(64, S=32)

    def saved_bytes(remat):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        lm = LM(port_config(jcfg, remat=remat))
        live = tree_unflatten(pp, [p.detach().requires_grad_()
                                   for p in tree_leaves(pp)])
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = lm.loss(live, batch)
        loss.backward()
        return total[0]

    assert saved_bytes(True) < saved_bytes(False)


def test_layer_views_follow_the_params_under_autograd():
    """Two loss gradients from two params trees: each call's gradients are
    its own (the per-layer views are made anew under autograd, never taken
    from the serving cache)."""
    jcfg = _tiny()
    _, pp = bridged_params(jcfg)
    lm = LM(port_config(jcfg))
    _, batch = _batch(64)
    with torch.no_grad():
        lm.apply(pp, batch)                 # fills the serving view cache
    (_, _), g1 = value_and_grad(lm.loss, pp, batch)
    scaled = dict(pp, layers={k: v for k, v in pp["layers"].items()})
    scaled["layers"]["ffn"] = {k: 2 * v for k, v in
                               pp["layers"]["ffn"].items()}
    (_, _), g2 = value_and_grad(lm.loss, scaled, batch)
    (_, _), g2b = value_and_grad(LM(port_config(jcfg)).loss, scaled, batch)
    for a, b in zip(tree_leaves(g2), tree_leaves(g2b)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b)
               for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
    assert all(float(g.abs().sum()) > 0 for g in tree_leaves(g1)
               if g.dim() > 0)


# ------------------------------------------------- train steps
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m"])
def test_train_steps_match_reference(arch, microbatches):
    """Three ``make_train_step`` steps at TRAIN_ADAM from one state on the
    same batches: params within 1e-5 absolute (Adam's update is at most
    ~lr = 3e-6 a step in warmup, so this holds the update itself), loss,
    ``ce_loss``, ``aux_loss``, ``grad_norm`` and ``lr`` within 1e-5
    relative."""
    jcfg = jsmoke(jget(arch))
    jp, pp = bridged_params(jcfg)
    jstep = jax.jit(jmake_train_step(jcfg, microbatches=microbatches))
    pstep = make_train_step(port_config(jcfg), microbatches=microbatches)
    js = jopt.adam_init(jp)
    ps = adam_state_from_jax(js, "cpu")
    for i in range(3):
        jbatch, pbatch = _batch(jcfg.vocab_size, B=4, seed=20 + i)
        jp, js, jm = jstep(jp, js, jbatch)
        pp, ps, pm = pstep(pp, ps, pbatch)
        for k in ("loss", "ce_loss", "aux_loss", "grad_norm", "lr"):
            assert abs(float(pm[k]) - float(jm[k])) <= LOSS_RTOL * max(
                abs(float(jm[k])), 1e-3), (i, k)
        for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(pp)):
            np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=0,
                                       atol=STEP_ATOL)
    assert int(ps.step) == 3


def test_train_step_leaves_its_inputs():
    """A step is a function of its inputs, as the reference's: the params
    and state it was given are unchanged."""
    jcfg = _tiny()
    _, pp = bridged_params(jcfg)
    before = [t.clone() for t in tree_leaves(pp)]
    st = adam_init(pp)
    _, batch = _batch(64)
    new, st2, _ = make_train_step(port_config(jcfg))(pp, st, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(pp)))
    assert int(st.step) == 0 and int(st2.step) == 1
    assert not all(torch.equal(a, b) for a, b in zip(before,
                                                     tree_leaves(new)))


# ------------------------------------------------- tests/test_configs_smoke.py
@pytest.mark.parametrize("arch", PORTED + MULTIMODAL)
def test_smoke_train_step(arch):
    """The reference's smoke train step on the port: finite loss, finite
    gradients, not all zero; the VLM's batch carries ``patch_embeds`` and
    the encoder-decoder's ``frames``, as the reference's smoke batch."""
    jcfg = jsmoke(jget(arch))
    lm = LM(port_config(jcfg))
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    _, batch = _batch(jcfg.vocab_size)
    gen = torch.Generator().manual_seed(8)
    if jcfg.frontend == "vision_patches":
        batch["patch_embeds"] = torch.randn(
            (2, jcfg.num_frontend_tokens, 1024), generator=gen)
    if jcfg.is_encoder_decoder:
        batch["frames"] = torch.randn((2, jcfg.enc_seq, 80), generator=gen)
    (loss, _), grads = value_and_grad(lm.loss, params, batch)
    assert np.isfinite(float(loss))
    flat = tree_leaves(grads)
    assert all(bool(torch.all(torch.isfinite(g))) for g in flat)
    assert sum(float(g.abs().sum()) for g in flat) > 0


def test_init_dtype_keeps_the_draws():
    """``LM.init(gen, dtype)`` stores the matrices in ``dtype`` and draws
    the same numbers: the bf16 default is the fp32 init rounded."""
    cfg = port_config(jsmoke(jget("tinyllama-1.1b")), dtype="bfloat16")
    lm = LM(cfg)
    p16 = lm.init(torch.Generator().manual_seed(4))
    p32 = lm.init(torch.Generator().manual_seed(4), dtype=torch.float32)
    assert p16["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in tree_leaves(p32))
    for a, b in zip(tree_leaves(p16), tree_leaves(p32)):
        assert torch.equal(a, b.to(a.dtype))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_kernel_plain_versions_carry_gradients_on_the_cpu(arch):
    """With ``use_kernels`` on CPU tensors the kernel wrappers run their
    plain versions, and autograd goes through them: the same loss and
    gradients as the model's own plain path, within fp32 rounding."""
    jcfg = jsmoke(jget(arch))
    _, pp = bridged_params(jcfg)
    _, batch = _batch(jcfg.vocab_size)
    (l0, _), g0 = value_and_grad(LM(port_config(jcfg)).loss, pp, batch)
    (l1, _), g1 = value_and_grad(
        LM(port_config(jcfg, use_kernels=True)).loss, pp, batch)
    assert abs(float(l1) - float(l0)) <= LOSS_RTOL * abs(float(l0))
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert float((a - b).abs().max()) <= GRAD_REL * float(a.abs().max())


def test_qblock_attention_gradients_match_reference():
    """Above 2048 tokens the plain prefill attends in query blocks
    (``flash_attend_qblocks``), each block checkpointed under autograd as
    in the reference: loss and gradients at S 2100 (five blocks, the last
    short) against the reference's."""
    jcfg = _tiny(num_layers=1, d_model=32, d_ff=64)
    jp, pp = bridged_params(jcfg)
    jbatch, pbatch = _batch(64, B=1, S=2100, masked=7)
    (jl, _), jg = _ref_loss_and_grads(jcfg, jp, jbatch)
    (pl, _), pg = value_and_grad(LM(port_config(jcfg)).loss, pp, pbatch)
    assert abs(float(pl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for a, b in zip(jax.tree_util.tree_leaves(jg), tree_leaves(pg)):
        a = np.asarray(a)
        assert np.abs(to_np(b) - a).max() <= GRAD_REL * np.abs(a).max()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_prefill_and_serve_steps_match_reference(arch):
    """``make_prefill_step`` then two ``make_serve_step`` calls against the
    reference's on one prompt: logits within 2e-4 absolute, 1e-4 relative
    (fp32 sums in other orders), the port's cache advanced in place."""
    from repro.launch.steps import make_prefill_step as jprefill
    from repro.launch.steps import make_serve_step as jserve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    jcfg = jsmoke(jget(arch))
    jp, pp = bridged_params(jcfg)
    pcfg = port_config(jcfg)
    jbatch, pbatch = _batch(jcfg.vocab_size, B=2, S=12)
    jl, jc = jax.jit(jprefill(jcfg, max_len=16))(jp, {"tokens":
                                                      jbatch["tokens"]})
    pl, pc = make_prefill_step(pcfg, max_len=16)(pp, {"tokens":
                                                      pbatch["tokens"]})
    jstep, pstep = jax.jit(jserve(jcfg)), make_serve_step(pcfg)
    for t in range(2):
        np.testing.assert_allclose(to_np(pl), np.asarray(jl), atol=2e-4,
                                   rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1))
        jl, jc = jstep(jp, jc, jnp.asarray(tok, jnp.int32))
        pl, pc = pstep(pp, pc, torch.tensor(tok))
        assert not pl.requires_grad
        assert pc["pos"].tolist() == [13 + t] * 2
    np.testing.assert_allclose(to_np(pl), np.asarray(jl), atol=2e-4,
                               rtol=1e-4)
