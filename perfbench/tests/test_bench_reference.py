"""The plain reference against the port at smoke size on the CPU: the
port's own forward pass, and the outputs of whole benchmark runs."""
import json
import time

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.reference import lm
from perfbench.tests.smoke import DENSE, MOE, make_root
from perfbench.weights import make_params


def _port(model, params):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import LM
    cfg = ModelConfig(name="smoke", **model)
    return cfg, LM(cfg)


@pytest.mark.parametrize("model", [MOE, DENSE], ids=["moe", "dense"])
def test_reference_logits_equal_the_ports_forward(model):
    params = make_params(model, 2**31 + 5, "cpu")
    cfg, port = _port(model, params)
    toks = torch.randint(1, model["vocab_size"], (3, 12),
                         generator=torch.Generator().manual_seed(0))
    toks[2, 5:] = 0                      # a zero-padded row
    want, _ = port.apply(params, {"tokens": toks})
    with torch.no_grad():
        h = lm.hidden(model, params, toks)
        got = lm.logits(model, params, h.reshape(-1, h.shape[-1]))
    want = want[..., :model["vocab_size"]].reshape(got.shape)
    assert torch.allclose(got, want.float(), atol=2e-4, rtol=2e-4)


def test_a_capacity_that_could_drop_tokens_is_refused(tmp_path):
    """The reference's router is dropless: a configuration whose experts'
    capacity could drop a token (here 1.25 x 2 of 4 experts) is refused
    before anything runs."""
    root = make_root(tmp_path)
    f = root / "perfbench" / "configs" / "smoke-moe.json"
    cfg = json.loads(f.read_text())
    cfg["model"]["moe_capacity_factor"] = 1.25
    f.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="dropless"):
        harness.run("smoke-moe.saturate", 1, 1.0, False,
                    t_start=time.perf_counter(), root=root, device="cpu",
                    log=lambda m: None)


@pytest.mark.parametrize("cell", ["smoke-moe.saturate",
                                  "smoke-dense.saturate",
                                  "smoke-moe.steady"])
def test_a_run_at_smoke_size_is_correct(tmp_path, cell):
    root = make_root(tmp_path)
    out = harness.run(cell, 2**31 + 21, 1.0, False,
                      t_start=time.perf_counter(), root=root, device="cpu",
                      log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 10
    assert out["checks"]["max_logit_gap"]["value"] < 1e-4
    assert list(out)[-1] == "checks"


def test_the_control_reads_more_than_the_program(tmp_path):
    """The fp8 control, at the same positions, puts other tokens first than
    the float32 program and the reference do (over every request served)."""
    root = make_root(tmp_path)
    seen = {}

    def after(data, model, params, group, prompt_len, got):
        every = [check.Served(seq=r.seq, prompt=r.plan.tokens,
                              output=np.asarray(r.req.output, np.int64))
                 for r in data.recs if r.done]
        g = check.gaps(model, params, every, prompt_len, quant="fp8")
        seen["control"] = float(g.max())
        seen["program"] = got["max_logit_gap"]
        return {}
    harness.run("smoke-dense.saturate", 3, 1.0, False,
                t_start=time.perf_counter(), root=root, device="cpu",
                log=lambda m: None, after_check=after)
    assert seen["program"] < 1e-4 < seen["control"]


def test_sampling_takes_the_longest_then_draws_from_the_seed():
    def s(seq, n):
        return check.Served(seq=seq, prompt=np.ones(4, np.int64),
                            output=np.ones(n, np.int64))
    served = [s(0, 3), s(1, 9), s(2, 2), s(3, 4), s(4, 9)]
    assert [x.seq for x in check.sample(served, 5, 1, 8)] == [1]
    picked = check.sample(served, 5, 100, 8)
    assert picked[0].seq == 1 and sorted(x.seq for x in picked) == \
        [0, 1, 2, 3, 4]
    assert len(check.sample(served, 5, 100, 3)) == 3
    assert check.sample(served, 5, 10, 8) == check.sample(served, 5, 10, 8)
