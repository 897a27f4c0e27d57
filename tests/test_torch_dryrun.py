"""The port's dry run (``repro_torch.launch.dryrun``) and the shape half of
``repro_torch.launch.steps`` against the reference.

  * ``params_shapes``, ``opt_shapes``, ``cache_shapes`` and
    ``batch_specs_for`` on meta equal the reference's ``jax.eval_shape``
    trees leaf by leaf (path, shape, dtype) for every arch × shape, at the
    dry run's dtypes; nothing leaves meta, qwen3-moe-235b-a22b and
    deepseek-67b at full size included. The cache's ``pos`` is int64 in the
    port (int32 in the reference): the one dtype that differs.
  * Per pair and mesh, the record's ``model_flops``, ``analytic_hbm_bytes``,
    FSDP decision, fallbacks, ``n_sharded`` and ``n_replicated`` equal what
    the reference's own functions give on its eval-shape trees. The
    reference's dry-run module is not imported: it sets ``XLA_FLAGS`` when
    imported, so its pre-compile steps are repeated here from its source.
  * On a two-layer fp32 smoke config the counted FLOPs of a prefill step
    and of a train step equal a hand count of their products; ``run_one``
    counts a step once and reads it back for the other mesh.
  * The CLI in subprocesses: one pair, then ``--both-meshes``, which finds
    the first in its cache, then a failing pair.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import _torch_parity  # noqa: F401  (thread limit)
from repro.analysis import roofline as jrl
from repro.configs import get_config as jget
from repro.configs.shapes import adapt_config_for_shape as jadapt
from repro.configs.shapes import get_shape as jshape
from repro.launch import steps as jsteps
from repro.sharding import policy as jpolicy
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, smoke_variant
from repro_torch.configs.shapes import adapt_config_for_shape, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch import steps as psteps

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(a, s) for a in ALL_ARCHS for s in sorted(SHAPES)
         if adapt_config_for_shape(get_config(a), get_shape(s))[0]
         is not None]
SERVE_FSDP_BYTES = 12e9     # the reference's dryrun.py:41


def _jax_abstract_mesh(sizes, names):
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


JMESH = {False: _jax_abstract_mesh((16, 16), ("data", "model")),
         True: _jax_abstract_mesh((2, 16, 16), ("pod", "data", "model"))}


def _cfgs(arch, shape_name):
    """(reference, port) configs of a pair at the dry run's dtypes."""
    kind = get_shape(shape_name).kind
    dts = dict(dtype="bfloat16",
               param_dtype="float32" if kind == "train" else "bfloat16")
    jc, _ = jadapt(jget(arch), jshape(shape_name))
    pc, _ = adapt_config_for_shape(get_config(arch), get_shape(shape_name))
    return jc.replace(**dts), pc.replace(**dts)


def _jleaves(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in leaves}


def _pleaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_pleaves(tree[k], path + (k,)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_pleaves(getattr(tree, f), path + (f,)))
        return out
    assert tree.device.type == "meta", path
    return {"/".join(path): (tuple(tree.shape),
                             str(tree.dtype).removeprefix("torch."))}


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_shapes_equal_the_reference_eval_shape(arch, shape_name):
    jc, pc = _cfgs(arch, shape_name)
    js, ps = jshape(shape_name), get_shape(shape_name)
    jp = jsteps.params_shapes(jc)
    pp = psteps.params_shapes(pc)
    assert _pleaves(pp) == _jleaves(jp)
    assert _pleaves(psteps.batch_specs_for(pc, ps)) == \
        _jleaves(jsteps.batch_specs_for(jc, js))
    if ps.kind == "train":
        assert _pleaves(psteps.opt_shapes(pp)) == \
            _jleaves(jsteps.opt_shapes(jp))
    if ps.kind == "decode":
        want = _jleaves(jsteps.cache_shapes(jc, js))
        got = _pleaves(psteps.cache_shapes(pc, ps))
        assert want.pop("pos") == (got["pos"][0], "int32")
        assert got.pop("pos") == ((ps.global_batch,), "int64")
        assert got == want


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-67b"])
def test_the_largest_configs_stay_on_meta(arch):
    """Every argument of every step of the two largest archs is a meta
    tensor at full size: 235 B and 67 B params allocate nothing."""
    from torch.utils._pytree import tree_leaves
    for shape_name in sorted(SHAPES):
        _, pc = _cfgs(arch, shape_name)
        _, args = psteps.input_specs(pc, get_shape(shape_name))
        leaves = [t for t in tree_leaves(args)
                  if isinstance(t, torch.Tensor)]
        assert len(leaves) > 10
        assert all(t.device.type == "meta" for t in leaves), shape_name
        n = sum(t.numel() for t in tree_leaves(args[0]))
        # the config's closed form leaves out a norm or two
        assert abs(n - pc.param_count()) < 1e-6 * n, (n, pc.param_count())


def _reference_record(arch, shape_name, multi_pod):
    """The reference dry run's pre-compile numbers (its ``_compile_once``
    and ``run_one`` up to ``lower``), on its eval-shape trees."""
    jc, _ = _cfgs(arch, shape_name)
    shape = jshape(shape_name)
    mesh = JMESH[multi_pod]
    _, args = jsteps.input_specs(jc, shape)
    params = args[0]
    param_bytes = sum(x.size * x.dtype.itemsize
                      for x in jax.tree_util.tree_leaves(params))
    fsdp = (shape.kind == "train"
            or param_bytes / mesh.shape["model"] > SERVE_FSDP_BYTES)
    _, report = jpolicy.param_specs(jc, params, mesh, fsdp=fsdp)
    bshard = 1
    for a in ("pod", "data"):
        if a in mesh.shape:
            bshard *= mesh.shape[a]
    if shape.global_batch % bshard or shape.global_batch < bshard:
        bshard = 1
    hbm = jrl.analytic_hbm_bytes(
        jc, shape, param_bytes_global=param_bytes,
        model_shard=mesh.shape["model"], batch_shard=bshard,
        fsdp_shard=mesh.shape.get("data", 1) if fsdp else 1,
        train=shape.kind == "train", microbatches=1)
    return {"model_flops": jrl.model_flops(jc, shape),
            "analytic_hbm_bytes": hbm, "fsdp": fsdp,
            "param_bytes_global": param_bytes,
            "sharding_fallbacks": report.fallbacks[:8],
            "n_sharded": len(report.sharded),
            "n_replicated": len(report.replicated)}


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_run_one_equals_the_reference_records(arch, shape_name):
    for multi_pod in (False, True):
        got, _ = dryrun.layout(arch, shape_name, multi_pod=multi_pod)
        want = _reference_record(arch, shape_name, multi_pod)
        assert {k: got[k] for k in want} == want, (arch, shape_name)
        assert got["fits_h100_80gb"] == (want["analytic_hbm_bytes"] < 80e9)
        assert got["collective_bytes"] is None
        per = got["per_device_bytes"]
        assert per["total"] == sum(v for k, v in per.items() if k != "total")
        assert 0 < per["params"] <= want["param_bytes_global"]


def test_skipped_pair_is_reported_as_the_reference_does():
    rec = dryrun.run_one("whisper-tiny", "long_500k")
    assert rec["skipped"] and rec["reason"].startswith("SKIP")


def _smoke2(remat):
    return smoke_variant(get_config("tinyllama-1.1b")).replace(
        num_layers=2, dtype="float32", param_dtype="float32", remat=remat)


def _layer_fwd_flops(cfg, B, S, T):
    """Products of one layer's forward over S query rows and T keys."""
    D, H, KV, hd, F_ = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.d_ff)
    proj = 2 * B * S * D * (H * hd + 2 * KV * hd) + 2 * B * S * H * hd * D
    attn = 2 * (2 * B * H * S * T * hd)           # scores and PV
    mlp = 2 * B * S * D * F_ * 2 + 2 * B * S * F_ * D
    return proj + attn + mlp


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_counted_flops_equal_a_hand_count(remat):
    """Prefill: every layer's products and the last position's unembed.
    Train: forward, a backward of two products a product (every operand
    requires grad: the embedding feeds the first layer) and, with remat,
    each layer's forward once more but its last product; logits at every
    position."""
    cfg = _smoke2(remat)
    B, S = 2, 16
    V, D, L = cfg.padded_vocab, cfg.d_model, cfg.num_layers
    shape = type(get_shape("train_4k"))("t", S, B, "prefill")
    fn, args = psteps.input_specs(cfg, shape)
    flops = dryrun.count_step(fn, args)
    assert flops == L * _layer_fwd_flops(cfg, B, S, S) + 2 * B * D * V
    shape = type(shape)("t", S, B, "train")
    fn, args = psteps.input_specs(cfg, shape)
    flops = dryrun.count_step(fn, args)
    layer = _layer_fwd_flops(cfg, B, S, S)
    unembed = 2 * B * S * D * V
    # the replay stops once the last saved tensor is recomputed
    # (``checkpoint``'s early stop): the MLP's down product, whose output
    # the backward does not need, runs no second time
    replay = layer - 2 * B * S * cfg.d_ff * D if remat else 0
    assert flops == 3 * L * layer + L * replay + 3 * unembed


def test_a_step_is_counted_once_and_read_back():
    """``run_one`` counts a step into ``counts`` and, for the other mesh of
    a dense model (the same step), reads it back; a count already there
    is read, not recounted."""
    counts = {}
    rec = dryrun.run_one("tinyllama-1.1b", "decode_32k", verbose=False,
                         counts=counts)
    _, step = dryrun.layout("tinyllama-1.1b", "decode_32k")
    fn, args, key, _ = step
    assert list(counts) == [key]
    assert rec["flops_counted_global"] == counts[key] == \
        dryrun.count_step(fn, args) > 0
    rec = dryrun.run_one("tinyllama-1.1b", "decode_32k", multi_pod=True,
                         verbose=False, counts=counts)
    assert list(counts) == [key]
    assert rec["flops_counted_global"] == counts[key]
    counts[key] = -1.0
    rec = dryrun.run_one("tinyllama-1.1b", "decode_32k", verbose=False,
                         counts=counts)
    assert rec["flops_counted_global"] == -1.0


def _cli(*argv, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--out", str(out)], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)


def test_cli_writes_one_json_a_pair_and_finds_its_cache(tmp_path):
    r = _cli("--arch", "tinyllama-1.1b", "--shape", "decode_32k",
             out=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dry-run complete" in r.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "tinyllama-1.1b__decode_32k__16x16.json"]
    r = _cli("--arch", "tinyllama-1.1b", "--shape", "decode_32k",
             "--both-meshes", out=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "tinyllama-1.1b__decode_32k__16x16: cached" in r.stdout
    rec = json.loads(
        (tmp_path / "tinyllama-1.1b__decode_32k__2x16x16.json").read_text())
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
    assert rec["collective_bytes"] is None and rec["dominant"] is None
    assert rec["collective_s"] is None and rec["memory_s"] is None
    assert rec["bytes_accessed"] is None
    assert rec["flops_split"] == "even_split"
    assert rec["hlo_flops_per_device"] * 512 == rec["flops_counted_global"]
    assert rec["usefulness"] == pytest.approx(
        rec["model_flops"] / rec["flops_counted_global"])
    assert rec["compute_s"] == pytest.approx(
        rec["hlo_flops_per_device"] / 989e12)
    r = _cli("--arch", "tinyllama-1.1b", "--shape", "decode_32k",
             "--both-meshes", out=tmp_path)
    assert r.stdout.count(": cached") == 2 and r.returncode == 0
    r = _cli("--arch", "no-such-arch", "--shape", "decode_32k",
             out=tmp_path)
    assert r.returncode == 1 and "FAILURES" in r.stdout
    assert "error" in json.loads(
        (tmp_path / "no-such-arch__decode_32k__16x16.json").read_text())
