"""Model-level parity cases shared by ``test_torch_encdec.py`` (whisper-tiny)
and ``test_torch_vlm.py`` (internvl2-26b): each takes a reference config,
draws the reference's ``LM.init`` weights, carries them to the port
(``bridge.params_from_jax``) and holds the port's call against the
reference's on inputs made from a numpy seed, with the stub frontends'
``frames`` (B, enc_seq, 80) and ``patch_embeds`` (B, P, 1024) where the
config has them. fp32 throughout: logits within ATOL absolute and RTOL
relative (sums in other orders), greedy tokens exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import bridged_params, np_tree, port_config, to_np  # noqa: F401
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.model import build_model as jbuild
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.bridge import adam_state_from_jax, params_from_jax
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models.model import LM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import tree_leaves, value_and_grad

ATOL, RTOL = 2e-4, 1e-4
TF_ATOL, TF_RTOL = 2e-3, 1e-3        # decode vs teacher forcing (reference)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_ATOL = 1e-5


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def batches(jcfg, B=2, S=12, seed=1, labels=False, text_only=False):
    """(reference batch, port batch) of ``tokens`` (and ``labels``, the
    tokens shifted by one with row 0's first two masked), plus the
    config's frontend stubs unless ``text_only``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    arrays = {"tokens": toks}
    if labels:
        lab = np.roll(toks, -1, axis=1)
        lab[0, :2] = -1
        arrays["labels"] = lab
    if jcfg.frontend == "vision_patches" and not text_only:
        arrays["patch_embeds"] = rng.standard_normal(
            (B, jcfg.num_frontend_tokens, 1024)).astype(np.float32)
    if jcfg.is_encoder_decoder:
        arrays["frames"] = rng.standard_normal(
            (B, jcfg.enc_seq, 80)).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in arrays.items()}
    pb = {k: torch.as_tensor(v) for k, v in arrays.items()}
    return jb, pb


def bridge_case(jcfg):
    """Every leaf of the reference's init reaches the port equal, the
    norms in the param dtype; a tree with a leaf missing raises."""
    jp, pp = bridged_params(jcfg)
    want = jax.tree_util.tree_leaves_with_path(jp)
    got = {".".join(k.key for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(
               _port_as_jax_tree(pp))}
    assert len(got) == len(want)
    for path, leaf in want:
        name = ".".join(k.key for k in path)
        np.testing.assert_array_equal(got[name], np.asarray(leaf))
    tree = np_tree(jp)
    key = "enc_norm" if jcfg.is_encoder_decoder else "vis_proj"
    del tree[key]
    try:
        params_from_jax(tree, port_config(jcfg), "cpu")
    except ValueError as e:
        assert key in str(e)
    else:
        raise AssertionError(f"a tree without {key} was accepted")
    return jp, pp


def _port_as_jax_tree(pp):
    if isinstance(pp, dict):
        return {k: _port_as_jax_tree(v) for k, v in pp.items()}
    return to_np(pp)


def apply_case(jcfg, text_only=False):
    """Teacher-forcing logits (B 2, S 12), the image prefix counted."""
    jp, pp = bridged_params(jcfg)
    jb, pb = batches(jcfg, text_only=text_only)
    jl, _ = jax.jit(lambda p, b: jbuild(jcfg).apply(p, b, train=False))(
        jp, jb)
    pl, _ = LM(port_config(jcfg)).apply(pp, pb)
    assert pl.shape == jl.shape
    assert bool(torch.isfinite(pl).all())
    close(pl, jl)
    return pl


def loss_case(jcfg):
    """``LM.loss`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's loss: loss within LOSS_RTOL, each leaf's max-abs
    difference within GRAD_REL of its max-abs."""
    jp, pp = bridged_params(jcfg)
    jb, pb = batches(jcfg, B=2, S=10, labels=True)
    m = jbuild(jcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: m.loss(p, jb),
                                             has_aux=True))(jp)
    (pl, _), pg = value_and_grad(LM(port_config(jcfg)).loss, pp, pb)
    assert abs(float(pl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want, got = jax.tree_util.tree_leaves(jg), tree_leaves(pg)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert b.shape == a.shape
        assert np.abs(to_np(b) - a).max() <= GRAD_REL * max(np.abs(a).max(),
                                                            1e-12)


def decode_case(jcfg, S=12):
    """The mirror of ``tests/test_models_consistency.py`` on both
    packages: prefill S - 3 tokens (after the image prefix) into a cache
    of prefix + S, then decode the last 3; the port's logits match the
    reference's call for call and the port's own teacher forcing; every
    cache leaf of the port matches the reference's."""
    jp, pp = bridged_params(jcfg)
    jm, pm = jbuild(jcfg), LM(port_config(jcfg))
    jb, pb = batches(jcfg, S=S)
    full, _ = pm.apply(pp, pb)
    off = full.shape[1] - S
    jpre = dict(jb, tokens=jb["tokens"][:, :S - 3])
    ppre = dict(pb, tokens=pb["tokens"][:, :S - 3])
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=off + S))(jp, jpre)
    pl, pc = pm.prefill(pp, ppre, max_len=off + S)
    close(pl, jl)
    close(pl, to_np(full[:, off + S - 4]), TF_ATOL, TF_RTOL)
    jstep = jax.jit(jm.decode_step)
    for i in range(3):
        jl, jc = jstep(jp, jc, jb["tokens"][:, S - 3 + i])
        pl, pc = pm.decode_step(pp, pc, pb["tokens"][:, S - 3 + i])
        close(pl, jl)
        close(pl, to_np(full[:, off + S - 3 + i]), TF_ATOL, TF_RTOL)
    assert set(pc) == set(jc)
    for k in pc:
        close(pc[k], jc[k], 1e-5, 0)


def kernels_case(jcfg):
    """Kernels on (the port's plain kernel versions on the CPU) against the
    reference with ``use_pallas=True`` (its Pallas kernels as its own CPU
    tests run them): ``apply``, then prefill and two decode steps."""
    jcfg = jcfg.replace(use_pallas=True)
    jp, pp = bridged_params(jcfg)
    jm, pm = jbuild(jcfg), LM(port_config(jcfg))
    assert pm.cfg.use_kernels
    jb, pb = batches(jcfg, S=8)
    jl, _ = jax.jit(lambda p, b: jm.apply(p, b, train=False))(jp, jb)
    close(pm.apply(pp, pb)[0], jl)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=40))(jp, jb)
    pl, pc = pm.prefill(pp, pb, max_len=40)
    close(pl, jl)
    for _ in range(2):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        pt = torch.argmax(pl, -1)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        jl, jc = jax.jit(jm.decode_step)(jp, jc, jt)
        pl, pc = pm.decode_step(pp, pc, pt)
        close(pl, jl)


def train_step_case(jcfg, microbatches):
    """Two ``make_train_step`` steps at ``microbatches`` against the
    reference's on the same batches (B 4, labels masked in row 0): losses
    within LOSS_RTOL, params within STEP_ATOL. At 2 microbatches also the
    mirror of ``tests/test_train.py``'s accumulation case on the port: one
    step on an unmasked batch equals the single-batch step (params within
    1e-5, loss within 1e-4)."""
    jp, pp = bridged_params(jcfg)
    jstep = jax.jit(jmake_train_step(jcfg, microbatches=microbatches))
    pstep = make_train_step(port_config(jcfg), microbatches=microbatches)
    js = jopt.adam_init(jp)
    ps = adam_state_from_jax(js, "cpu")
    if microbatches > 1:
        _, pb = batches(jcfg, B=4, S=8, seed=19)
        pb["labels"] = torch.roll(pb["tokens"], -1, 1)
        p1, _, m1 = make_train_step(port_config(jcfg))(pp, ps, pb)
        p2, _, m2 = pstep(pp, ps, pb)
        assert max(float((a - b).abs().max())
                   for a, b in zip(tree_leaves(p1), tree_leaves(p2))) < 1e-5
        assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for i in range(2):
        jb, pb = batches(jcfg, B=4, S=8, seed=20 + i, labels=True)
        jp, js, jmet = jstep(jp, js, jb)
        pp, ps, pmet = pstep(pp, ps, pb)
        for k in ("loss", "ce_loss", "grad_norm", "lr"):
            assert abs(float(pmet[k]) - float(jmet[k])) <= LOSS_RTOL * max(
                abs(float(jmet[k])), 1e-3), (i, k)
        for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(pp)):
            np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=0,
                                       atol=STEP_ATOL)


def prefill_step_case(jcfg):
    """``make_prefill_step`` carries the frontend stubs to the model."""
    from repro.launch.steps import make_prefill_step as jprefill
    jp, pp = bridged_params(jcfg)
    jb, pb = batches(jcfg, S=6)
    jl, _ = jax.jit(jprefill(jcfg, max_len=40))(jp, jb)
    pl, _ = make_prefill_step(port_config(jcfg), max_len=40)(pp, pb)
    close(pl, jl)


def checkpoint_case(jcfg, tmp_path, direction):
    """A params + AdamState tree saved by one package restores in the
    other with equal arrays."""
    jp, pp = bridged_params(jcfg)
    js = jopt.adam_init(jp)
    state = {"params": pp, "opt": adam_state_from_jax(js, "cpu")}
    if direction == "port-to-reference":
        ckpt.save(str(tmp_path), 5, state, metadata={"loss": 1.0})
        back, meta = jckpt.restore(str(tmp_path), {"params": jp, "opt": js})
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(back)]
    else:
        jckpt.save(str(tmp_path), 5, {"params": jp, "opt": js},
                   metadata={"loss": 1.0})
        back, meta = ckpt.restore(str(tmp_path), state)
        leaves = [to_np(x) if x.is_floating_point() else x.numpy()
                  for x in tree_leaves(back)]
    assert meta == {"loss": 1.0}
    want = jax.tree_util.tree_leaves({"params": jp, "opt": js})
    assert len(leaves) == len(want)
    for a, b in zip(want, leaves):
        np.testing.assert_array_equal(b, np.asarray(a))


def engine_failure(make, label):
    """The exception type and message of building a one-backend engine of
    ``make()`` and allocating its variant."""
    try:
        eng = make()
        eng.apply_allocation(0.0, {label: 1})
    except Exception as e:                              # noqa: BLE001
        return type(e).__name__, str(e)
    raise AssertionError(f"{label}: the engine built")
