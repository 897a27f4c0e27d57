"""The port's sharding policy, activation context and production mesh
(``repro_torch.sharding``, ``repro_torch.launch.mesh``) against the
reference's: the seven cases of tests/test_sharding_policy.py and the three
of tests/test_context.py on the port; every param spec, fallback, cache spec
and batch spec equal to the reference's ``PartitionSpec`` (as a tuple) for
every arch and shape on both production meshes, FSDP off and on; shards of
meta tensors distributed by ``to_placements`` over a fake process group of
world 256; and ``apply_moe``'s dispatch groups: bitwise unchanged under an
inert context, and at two groups equal to the reference's under a
two-device host mesh (in a subprocess, as the device count is fixed when
JAX starts)."""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _torch_parity  # noqa: F401  (thread limit)
from repro.configs import get_config as jget
from repro.configs.shapes import pairs as jpairs
from repro.launch import steps as jsteps
from repro.sharding import policy as jpolicy
from repro_torch.configs import ALL_ARCHS, get_config, smoke_variant
from repro_torch.configs.shapes import adapt_config_for_shape, get_shape
from repro_torch.configs.shapes import pairs as ppairs
from repro_torch.launch import steps as psteps
from repro_torch.launch.mesh import (AbstractMesh, batch_axes,
                                     batch_axis_size, make_production_mesh,
                                     model_axis_size, production_geometry)
from repro_torch.models import moe as pmoe
from repro_torch.sharding.context import (activation_sharding,
                                          batch_shard_size, constrain,
                                          constrain_batch)
from repro_torch.sharding.policy import (P, batch_specs, cache_specs,
                                         local_shape, param_specs,
                                         to_placements, tree_map_with_path)

ROOT = Path(__file__).resolve().parents[1]
MESH = production_geometry()
POD_MESH = production_geometry(multi_pod=True)


def _jax_abstract_mesh(sizes, names):
    """AbstractMesh across jax versions: 0.4.x takes ((name, size), ...);
    newer releases take (sizes, names)."""
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


JMESH = {"16x16": _jax_abstract_mesh((16, 16), ("data", "model")),
         "2x16x16": _jax_abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
PMESH = {"16x16": MESH, "2x16x16": POD_MESH}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jsteps.params_shapes(jget(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return psteps.params_shapes(get_config(arch))


def _jflat(specs):
    """{path: tuple(spec)} of a reference spec tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(sp)
            for path, sp in leaves}


def _pflat(specs):
    out = {}

    def visit(path, sp):
        out["/".join(path)] = sp
    _walk(specs, (), visit)
    return out


def _walk(tree, path, fn):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (k,), fn)
    else:
        fn(path, tree)


def _find(specs, path_fragment):
    return {k: v for k, v in _pflat(specs).items() if path_fragment in k}


# ------------------------------------- tests/test_sharding_policy.py, ported
def test_dense_tp_sharding_tinyllama():
    cfg = get_config("tinyllama-1.1b")      # 32 heads, kv=4, d_ff 5632
    specs, report = param_specs(cfg, _port_params("tinyllama-1.1b"), MESH)
    wq = list(_find(specs, "attn/wq").values())[0]
    assert wq == P(None, None, "model")     # heads 32 % 16 == 0
    wk = list(_find(specs, "attn/wk").values())[0]
    assert wk == P(None, None, None)        # kv=4 !% 16 -> replicated
    wi = list(_find(specs, "ffn/wi").values())[0]
    assert wi == P(None, None, "model")     # d_ff 5632 % 16 == 0
    emb = list(_find(specs, "embed/table").values())[0]
    assert emb == P("model", None)          # padded vocab % 16 == 0
    assert any("wk" in f for f in report.fallbacks)


def test_gemma_heads_fallback():
    cfg = get_config("gemma-2b")            # 8 heads < 16
    specs, report = param_specs(cfg, _port_params("gemma-2b"), MESH)
    wq = list(_find(specs, "attn/wq").values())[0]
    assert wq == P(None, None, None)
    wi = list(_find(specs, "ffn/wi").values())[0]
    assert wi == P(None, None, "model")     # FFN carries the TP instead


def test_moe_expert_parallel_vs_dff_fallback():
    qwen = get_config("qwen3-moe-235b-a22b")    # 128 experts % 16 == 0
    specs, _ = param_specs(qwen, _port_params("qwen3-moe-235b-a22b"), MESH)
    wi = list(_find(specs, "ffn/wi").values())[0]
    assert wi == P(None, "model", None, None)   # expert-parallel
    gran = get_config("granite-moe-3b-a800m")   # 40 experts !% 16
    specs, report = param_specs(gran, _port_params("granite-moe-3b-a800m"),
                                MESH)
    wi = list(_find(specs, "ffn/wi").values())[0]
    assert wi == P(None, None, None, "model")   # d_ff fallback (512 % 16)
    assert any("E=40" in f for f in report.fallbacks)


def test_fsdp_adds_data_axis():
    cfg = get_config("yi-6b")
    specs, _ = param_specs(cfg, _port_params("yi-6b"), MESH, fsdp=True)
    wq = list(_find(specs, "attn/wq").values())[0]
    assert "data" in wq and "model" in wq


def test_every_arch_every_leaf_gets_a_spec():
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        params = _port_params(arch)
        specs, _ = param_specs(cfg, params, MESH, fsdp=True)

        def check(path, p, sp):
            assert isinstance(sp, tuple)
            assert len(sp) <= len(p.shape)
            for ax, dim in zip(sp, p.shape):
                if ax is not None:
                    assert dim % 16 == 0, (arch, p.shape, sp)
        tree_map_with_path(check, params, specs)


def test_cache_specs_shard_batch_and_sequence():
    cfg = get_config("tinyllama-1.1b")
    shape = get_shape("decode_32k")
    cache = psteps.cache_shapes(cfg, shape)
    specs = cache_specs(cfg, cache, MESH, shape.global_batch)
    assert specs["k"] == P(None, ("data",), None, "model", None)
    # long_500k: batch 1 -> replicated batch
    shape_l = get_shape("long_500k")
    cfg_l, _ = adapt_config_for_shape(cfg, shape_l)
    cache = psteps.cache_shapes(cfg_l, shape_l)
    specs = cache_specs(cfg_l, cache, MESH, 1)
    assert specs["k"][1] is None


def test_multipod_batch_axes():
    cfg = get_config("tinyllama-1.1b")
    shape = get_shape("train_4k")
    b = batch_specs(cfg, psteps.batch_specs_for(cfg, shape), POD_MESH, 256)
    assert b["tokens"] == P(("pod", "data"), None)


# ------------------------------------------ tests/test_context.py, ported
def test_noop_without_context():
    x = torch.ones((8, 4))
    assert constrain_batch(x) is x
    assert batch_shard_size() == 1
    y = constrain(x, "batch", None)
    assert y is x


def test_model_outputs_identical_with_singleton_mesh():
    """With a 1x1 mesh the constraints exist but results are unchanged
    (bitwise: plain tensors pass through)."""
    from repro_torch.models.model import LM
    cfg = smoke_variant(get_config("granite-moe-3b-a800m"))
    m = LM(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    base, _ = m.apply(p, {"tokens": toks}, train=False)
    with activation_sharding(AbstractMesh(("data", "model"), (1, 1)),
                             ("data",)):
        assert batch_shard_size() == 1
        pinned, _ = m.apply(p, {"tokens": toks}, train=False)
    assert torch.equal(base, pinned)


def test_indivisible_dims_left_alone():
    with activation_sharding(AbstractMesh(("data", "model"), (1, 1)),
                             ("data",)):
        x = torch.ones((7, 3))
        y = constrain_batch(x)
        assert y.shape == x.shape


# ------------------------------------------------ the mesh helpers
def test_mesh_helpers_on_both_geometries():
    assert MESH.shape == {"data": 16, "model": 16} and MESH.size == 256
    assert POD_MESH.shape == {"pod": 2, "data": 16, "model": 16}
    assert batch_axes(MESH) == ("data",)
    assert batch_axes(POD_MESH) == ("pod", "data")
    assert model_axis_size(POD_MESH) == 16
    assert (batch_axis_size(MESH), batch_axis_size(POD_MESH)) == (16, 32)


# ------------------------------- every leaf against the reference's spec
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(PMESH))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, fsdp):
    """Every leaf's spec is tuple(the reference's PartitionSpec) and the
    reports' lists are equal, in the reference's order; the port's params
    are meta leaves of the reference's shapes and dtypes."""
    jspecs, jrep = jpolicy.param_specs(jget(arch), _ref_params(arch),
                                       JMESH[mesh], fsdp=fsdp)
    pspecs, prep = param_specs(get_config(arch), _port_params(arch),
                               PMESH[mesh], fsdp=fsdp)
    assert _pflat(pspecs) == _jflat(jspecs)
    assert prep.fallbacks == jrep.fallbacks
    assert prep.replicated == jrep.replicated
    assert prep.sharded == jrep.sharded


@pytest.mark.parametrize("mesh", sorted(PMESH))
def test_cache_and_batch_specs_equal_the_reference_for_every_pair(mesh):
    """``cache_specs`` (decode shapes) and ``batch_specs`` over every
    ``configs.shapes.pairs`` entry, leaf by leaf."""
    jp = jpairs([jget(a) for a in ALL_ARCHS])
    pp = ppairs([get_config(a) for a in ALL_ARCHS])
    assert [(c.name, s.name) for c, s, _ in pp] == \
        [(c.name, s.name) for c, s, _ in jp]
    for (jc, js, _), (pc, ps, _) in zip(jp, pp):
        gb = ps.global_batch
        want = _jflat(jpolicy.batch_specs(
            jc, jsteps.batch_specs_for(jc, js), JMESH[mesh], gb))
        got = _pflat(batch_specs(pc, psteps.batch_specs_for(pc, ps),
                                 PMESH[mesh], gb))
        assert got == want, (pc.name, ps.name)
        if ps.kind != "decode":
            continue
        want = _jflat(jpolicy.cache_specs(
            jc, jsteps.cache_shapes(jc, js), JMESH[mesh], gb))
        got = _pflat(cache_specs(pc, psteps.cache_shapes(pc, ps),
                                 PMESH[mesh], gb))
        assert got == want, (pc.name, ps.name)


# -------------------------- DTensor shards over a fake process group
@pytest.fixture
def fake_world_256():
    """A fake process group of world 256 (no collective runs), destroyed
    after the test: xdist workers run several files in turn."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield make_production_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "whisper-tiny"])
def test_to_placements_shards_meta_leaves(fake_world_256, arch):
    """Params (FSDP on) and a decode cache distributed as DTensors by
    ``to_placements`` hold, on rank 0, the global shape divided by the
    spec's axis sizes (``local_shape``), and still lie on meta."""
    from torch.distributed.tensor import distribute_tensor
    mesh = fake_world_256
    cfg = get_config(arch)
    params = _port_params(arch)
    specs, _ = param_specs(cfg, params, mesh, fsdp=True)
    shape = get_shape("decode_32k")
    cache = psteps.cache_shapes(cfg, shape)
    cspecs = cache_specs(cfg, cache, mesh, shape.global_batch)
    n = [0]

    def check(path, t, sp):
        d = distribute_tensor(t, mesh, to_placements(sp, mesh))
        local = d.to_local()
        assert local.device.type == "meta"
        want = tuple(t.shape)
        for dim, entry in enumerate(sp):
            for ax in (() if entry is None else
                       (entry,) if isinstance(entry, str) else entry):
                want = want[:dim] + (want[dim] // mesh.shape[
                    mesh.mesh_dim_names.index(ax)],) + want[dim + 1:]
        assert tuple(local.shape) == want == local_shape(t.shape, sp, mesh)
        n[0] += 1
    tree_map_with_path(check, params, specs)
    tree_map_with_path(check, cache, cspecs)
    assert n[0] > 10


def test_to_placements_puts_two_axes_on_one_dim():
    from torch.distributed.tensor import Replicate, Shard
    assert to_placements(P(("pod", "data"), None, "model"), POD_MESH) == (
        Shard(0), Shard(0), Shard(2))
    assert to_placements(P(None, None), MESH) == (Replicate(), Replicate())
    assert local_shape((64, 8, 32), P(("pod", "data"), None, "model"),
                       POD_MESH) == (2, 8, 2)


def test_constrain_redistributes_a_dtensor(fake_world_256):
    """Under a context a DTensor is redistributed to the pinned placements
    (on meta: the placements change, no collective runs); with no context,
    or on a plain tensor, nothing changes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake_world_256
    x = distribute_tensor(torch.empty((32, 8, 64), device="meta"), mesh,
                          [Replicate(), Replicate()])
    assert constrain_batch(x) is x
    with activation_sharding(mesh, ("data",)):
        y = constrain_batch(x)
        assert tuple(y.placements) == (Shard(0), Replicate())
        z = constrain(x, "batch", None, "model")
        assert tuple(z.placements) == (Shard(0), Shard(2))
        plain = torch.ones((32, 4))
        assert constrain_batch(plain) is plain


# ------------------------------------------ the MoE dispatch groups
def _granite_moe_inputs(B=4, S=14, seed=3):
    cfg = smoke_variant(get_config("granite-moe-3b-a800m"))
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "wi": rng.standard_normal((E, D, F_)) / np.sqrt(E),
         "wg": rng.standard_normal((E, D, F_)) / np.sqrt(E),
         "wo": rng.standard_normal((E, F_, D)) / np.sqrt(E)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return cfg, p, x


def test_apply_moe_bitwise_under_an_inert_context():
    cfg, p, x = _granite_moe_inputs()
    tp = {k: torch.tensor(v) for k, v in p.items()}
    base = pmoe.apply_moe(cfg, tp, torch.tensor(x), capacity_factor=1.0)
    with activation_sharding(AbstractMesh(("data", "model"), (1, 16)),
                             ("data",)):
        inert = pmoe.apply_moe(cfg, tp, torch.tensor(x), capacity_factor=1.0)
    assert torch.equal(base[0], inert[0])
    for k in base[1]:
        assert torch.equal(base[1][k], inert[1][k]), k


_REF_MOE_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, smoke_variant
    from repro.models import moe
    from repro.sharding.context import activation_sharding
    d = np.load(sys.argv[1])
    cfg = smoke_variant(get_config("granite-moe-3b-a800m"))
    p = {k: jnp.asarray(d[k]) for k in ("router", "wi", "wg", "wo")}
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh((2, 1), ("data", "model"), **kw)
    assert len(jax.devices()) == 2
    with activation_sharding(mesh, ("data",)):
        y, m = jax.jit(lambda p, x: moe.apply_moe(
            cfg, p, x, capacity_factor=1.0))(p, jnp.asarray(d["x"]))
    np.savez(sys.argv[2], y=np.asarray(y),
             **{k: np.asarray(v) for k, v in m.items()})
""")


def test_apply_moe_two_groups_equal_the_reference_on_two_devices(tmp_path):
    """granite's smoke MoE at capacity factor 1.0 with
    ``batch_shard_size()`` 2 (two dispatch groups of 28 tokens, 16 slots an
    expert each) against the reference's under a (2, 1) host mesh: outputs
    within 1e-5 of their largest magnitude (fp32 sums of 256 and 512 terms
    in other orders), drop fractions equal, and not the one-group
    answer."""
    cfg, p, x = _granite_moe_inputs()
    np.savez(tmp_path / "in.npz", x=x, **p)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_MOE_SCRIPT,
                          str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    tp = {k: torch.tensor(v) for k, v in p.items()}
    one, m1 = pmoe.apply_moe(cfg, tp, torch.tensor(x), capacity_factor=1.0)
    with activation_sharding(AbstractMesh(("data", "model"), (2, 1)),
                             ("data",)):
        assert batch_shard_size() == 2
        two, m2 = pmoe.apply_moe(cfg, tp, torch.tensor(x),
                                 capacity_factor=1.0)
    err = np.abs(two.numpy() - ref["y"]).max() / np.abs(ref["y"]).max()
    assert err <= 1e-5, err
    # the same 2 of 224 picks dropped (XLA sums the mean per shard)
    assert float(ref["drop_fraction"]) > 0
    assert float(m2["drop_fraction"]) == pytest.approx(
        float(ref["drop_fraction"]), abs=1e-6)
    assert float(m2["aux_loss"]) == pytest.approx(float(ref["aux_loss"]),
                                                  rel=1e-5)
    assert not torch.allclose(one, two, atol=1e-3)
