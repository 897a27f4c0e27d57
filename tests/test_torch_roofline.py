"""The port's roofline module (``repro_torch.analysis.roofline``) against
the reference's: the seven cases of tests/test_analysis.py run on both
packages with the same inputs, the closed forms equal across packages for
every arch and shape, and ``analyze`` under the H100's constants divided
by hand."""
import pytest

import _torch_parity  # noqa: F401  (thread limit)
from repro.analysis import roofline as ref_rl
from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro_torch.analysis import roofline as port_rl
from repro_torch.configs import ALL_ARCHS, SHAPES
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import get_shape as port_get_shape
from repro_torch.core.profiles import HBM_BW, PEAK_FLOPS_BF16

PKGS = {"reference": (ref_rl, ref_get_config, ref_get_shape),
        "port": (port_rl, port_get_config, port_get_shape)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_collective_bytes_parsing(pkg):
    rl = pkg[0]
    hlo = """
  %ag = f32[16,1024]{1,0} all-gather(f32[1,1024]{1,0} %x), dimensions={0}
  %ar = bf16[512]{0} all-reduce(bf16[512]{0} %y), to_apply=%add
  %a2a = f32[8,64]{1,0} all-to-all(f32[8,64]{1,0} %z), dimensions={0}
"""
    total, per_kind = rl.collective_bytes(hlo)
    assert per_kind["all-gather"] == 16 * 1024 * 4
    assert per_kind["all-reduce"] == 512 * 2 * 2      # counted twice
    assert per_kind["all-to-all"] == 8 * 64 * 4
    assert total == sum(per_kind.values())


def test_collective_bytes_async_pairs_not_double_counted(pkg):
    rl = pkg[0]
    hlo = """
  %s = f32[1024]{0} all-reduce-start(f32[1024]{0} %x), to_apply=%add
  %d = f32[1024]{0} all-reduce-done(f32[1024]{0} %s)
"""
    total, _ = rl.collective_bytes(hlo)
    assert total == 1024 * 4 * 2  # one AR (x2), not two


def test_analyze_dominant_term(pkg):
    rl = pkg[0]
    cost = {"flops": 197e12 * 0.001, "bytes accessed": 819e9 * 0.005}
    rep = rl.analyze("a", "s", "16x16", 256, cost, "", 1e15)
    assert rep.dominant == "memory"
    assert abs(rep.compute_s - 0.001) < 1e-6
    assert abs(rep.memory_s - 0.005) < 1e-6


def test_model_flops_conventions(pkg):
    rl, get_config, get_shape = pkg
    cfg = get_config("tinyllama-1.1b")
    tr = rl.model_flops(cfg, get_shape("train_4k"))
    de = rl.model_flops(cfg, get_shape("decode_32k"))
    n = cfg.active_param_count()
    assert abs(tr - 6 * n * 256 * 4096) / tr < 1e-6
    assert abs(de - 2 * n * 128) / de < 1e-6


def test_moe_active_flops_less_than_total(pkg):
    cfg = pkg[1]("qwen3-moe-235b-a22b")
    assert cfg.active_param_count() < 0.2 * cfg.param_count()


def test_analytic_hbm_decreases_with_microbatching(pkg):
    rl, get_config, get_shape = pkg
    cfg = get_config("deepseek-67b")
    shape = get_shape("train_4k")
    kw = dict(param_bytes_global=cfg.param_count() * 2.0, model_shard=16,
              batch_shard=16, fsdp_shard=16, train=True)
    m1 = rl.analytic_hbm_bytes(cfg, shape, microbatches=1, **kw)
    m16 = rl.analytic_hbm_bytes(cfg, shape, microbatches=16, **kw)
    assert m16 < m1 / 4


def test_scan_corrections_zero_for_decode(pkg):
    rl, get_config, get_shape = pkg
    cfg = get_config("tinyllama-1.1b")
    f, b, _ = rl.scan_corrections(cfg, get_shape("decode_32k"),
                                  batch_shard=16, model_shard=16,
                                  heads_sharded=True)
    assert f == 0.0 and b == 0.0


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_closed_forms_equal_the_reference(shape):
    """model_flops, analytic_hbm_bytes (train and serve, FSDP on and off,
    microbatches 1 and 4) and scan_corrections are the same numbers in
    both packages for every arch."""
    for arch in ALL_ARCHS:
        rc, pc = ref_get_config(arch), port_get_config(arch)
        rs, ps = ref_get_shape(shape), port_get_shape(shape)
        assert port_rl.model_flops(pc, ps) == ref_rl.model_flops(rc, rs)
        for fsdp, mb in ((1, 1), (16, 4)):
            kw = dict(param_bytes_global=rc.param_count() * 2.0,
                      model_shard=16, batch_shard=16, fsdp_shard=fsdp,
                      train=rs.kind == "train", microbatches=mb)
            assert (port_rl.analytic_hbm_bytes(pc, ps, **kw)
                    == ref_rl.analytic_hbm_bytes(rc, rs, **kw))
        kw = dict(batch_shard=16, model_shard=16, heads_sharded=True)
        assert (port_rl.scan_corrections(pc, ps, **kw)
                == ref_rl.scan_corrections(rc, rs, **kw))


def test_analyze_takes_the_h100_constants():
    """Under the H100's keywords each term divides by the H100's rate; an
    unmeasured bytes count or collective count leaves its term and the
    dominant term None, never 0."""
    cost = {"flops": 3.0e12, "bytes accessed": 6.7e9}
    rep = port_rl.analyze("a", "s", "16x16", 256, cost, None, 7.68e14,
                          collective_override=9.0e8,
                          peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                          link_bw=port_rl.NVLINK_BW)
    assert rep.compute_s == 3.0e12 / 989e12
    assert rep.memory_s == 6.7e9 / 3.35e12
    assert rep.collective_s == 9.0e8 / 450e9
    assert rep.dominant == "compute"
    assert rep.usefulness == 7.68e14 / (3.0e12 * 256)
    rep = port_rl.analyze("a", "s", "16x16", 256, cost, None, 1e15,
                          peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                          link_bw=port_rl.NVLINK_BW)
    assert rep.collective_bytes_per_device is None
    assert rep.collective_s is None and rep.dominant is None
    rep = port_rl.analyze("a", "s", "16x16", 256,
                          {"flops": 1e12, "bytes accessed": None}, "", 1e15)
    assert rep.memory_s is None and rep.dominant is None
    assert rep.collective_s == 0.0           # parsed HLO with no collective
