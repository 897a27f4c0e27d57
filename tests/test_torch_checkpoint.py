"""The port's checkpoints: the four cases of ``tests/test_checkpoint.py``
on the port's trees, and checkpoints across packages: a params +
``AdamState`` tree written by either package restores in the other with
equal arrays (the same keys, ``opt/.step`` for the NamedTuple field, the
same on-disk layout)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged_params, port_config
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.bridge import adam_state_from_jax
from repro_torch.models.model import LM
from repro_torch.train import checkpoint as ckpt
from repro.models.model import build_model as jbuild
from repro_torch.train.optimizer import (AdamConfig, adam_init, adam_update,
                                         tree_leaves, tree_map)


def _jcfg():
    """The reference checkpoint test's config."""
    return jsmoke(jget("tinyllama-1.1b")).replace(
        num_layers=2, d_model=32, d_ff=64, vocab_size=64)


def _params():
    return LM(port_config(_jcfg())).init(torch.Generator().manual_seed(0),
                                         dtype=torch.float32)


def _ref_params(seed):
    return jax.jit(jbuild(_jcfg()).init)(jax.random.PRNGKey(seed))


def _trained_state(params):
    """params + an AdamState one step in, so no moment is all zeros."""
    grads = tree_map(lambda p: torch.full_like(p, 0.01), params)
    p, opt, _ = adam_update(AdamConfig(warmup_steps=0), grads,
                            adam_init(params), params)
    return {"params": p, "opt": opt}


def test_roundtrip(tmp_path):
    params = _params()
    opt = adam_init(params)
    state = {"params": params, "opt": opt}
    ckpt.save(str(tmp_path), 100, state, metadata={"loss": 1.5})
    restored, meta = ckpt.restore(str(tmp_path), state)
    assert meta["loss"] == 1.5
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_prune(tmp_path):
    params = {"w": torch.ones(3)}
    for s in (1, 5, 9, 12):
        ckpt.save(str(tmp_path), s, params)
    assert ckpt.latest_step(str(tmp_path)) == 12
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 12
    restored, _ = ckpt.restore(str(tmp_path), params, step=9)
    assert sorted(os.listdir(tmp_path)) == ["step_000000009",
                                            "step_000000012"]


def test_structure_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(3)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"w": torch.ones(3), "b": torch.ones(2)})


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"w": torch.ones(1)})


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"w": torch.ones(4)})


def test_bf16_leaves_round_trip(tmp_path):
    """numpy has no bfloat16: such a leaf is written as its float32 value
    and restored to bfloat16 exactly."""
    t = torch.randn(5, 3).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 2, {"t": t})
    back, _ = ckpt.restore(str(tmp_path), {"t": torch.zeros_like(t)})
    assert back["t"].dtype == torch.bfloat16 and torch.equal(back["t"], t)


def test_keys_and_manifest_match_the_reference(tmp_path):
    """One params + AdamState tree saved by both packages: the same keys,
    shapes and dtypes in the manifest and the same arrays in the npz."""
    jp, pp = bridged_params(_jcfg())
    js = jopt.adam_init(jp)
    jckpt.save(str(tmp_path / "ref"), 3, {"params": jp, "opt": js})
    ckpt.save(str(tmp_path / "port"), 3,
              {"params": pp, "opt": adam_state_from_jax(js, "cpu")})
    man = [json.load(open(tmp_path / d / "step_000000003" / "manifest.json"))
           for d in ("ref", "port")]
    assert "opt/.step" in man[0]["keys"]
    for k in ("keys", "shapes", "dtypes"):
        assert man[1][k] == man[0][k], k
    with np.load(tmp_path / "ref/step_000000003/arrays.npz") as a, \
            np.load(tmp_path / "port/step_000000003/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params = _params()
    state = _trained_state(params)
    ckpt.save(str(tmp_path), 7, state, metadata={"loss": 2.0})
    jp = _ref_params(1)
    like = {"params": jp, "opt": jopt.adam_init(jp)}
    back, meta = jckpt.restore(str(tmp_path), like)
    assert meta == {"loss": 2.0}
    assert int(back["opt"].step) == 1
    for a, b in zip(tree_leaves(state), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jp = _ref_params(2)
    g = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.01), jp)
    jp2, js, _ = jopt.adam_update(jopt.AdamConfig(warmup_steps=0), g,
                                  jopt.adam_init(jp), jp)
    jckpt.save(str(tmp_path), 4, {"params": jp2, "opt": js},
               metadata={"loss": 3.0})
    params = _params()
    like = {"params": params, "opt": adam_init(params)}
    back, meta = ckpt.restore(str(tmp_path), like)
    assert meta == {"loss": 3.0}
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 1
    for a, b in zip(jax.tree_util.tree_leaves({"params": jp2, "opt": js}),
                    tree_leaves(back)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
