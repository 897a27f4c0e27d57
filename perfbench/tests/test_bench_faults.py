"""A run whose timed path is broken underneath comes out not correct:
drives the whole run at smoke size on the CPU (the look for a card is the
only part skipped), once for each fault a served cell can have
(``perfbench/faults.py``)."""
import json
import time

import numpy as np
import pytest

from perfbench import faults, harness
from perfbench.tests.smoke import make_root


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", ["smoke-moe.saturate",
                                  "smoke-dense.saturate"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, cell):
    root = make_root(tmp_path)
    # a fault that spoils a share of the requests (half of those admitted
    # together) is caught by a sample of some tens of them
    f = root / "perfbench" / "cells" / f"{cell}.json"
    geo = json.loads(f.read_text())
    geo["check_rows"] = 64
    geo["limits"]["tokens_compared"] = 120
    f.write_text(json.dumps(geo))
    with faults.planted(fault):
        out = harness.run(cell, 2**31 + 77, 2.0, False,
                          t_start=time.perf_counter(), root=root,
                          device="cpu", log=lambda m: None)
    assert out["correct"] is False
    assert out["checks"]["max_logit_gap"]["value"] > \
        out["checks"]["max_logit_gap"]["limit"]
    assert np.isfinite(out["checks"]["max_logit_gap"]["value"])


def test_a_planted_fault_is_removed_on_leaving():
    from repro_torch.serving.engine import VariantBackend
    real = VariantBackend.__dict__["_finish"]
    with faults.planted("token-altered"):
        assert VariantBackend.__dict__["_finish"] is not real
    assert VariantBackend.__dict__["_finish"] is real
