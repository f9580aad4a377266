"""A whole run of each cell at a tiny size on the CPU (no card here):
the result line's keys, every answer compared, and the readers that find
nothing to read on the CPU left out of the line."""

import json

import pytest

from portbench.tests import tiny


@pytest.mark.parametrize("name", sorted(tiny.SIZES))
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run(name, trace):
    out = tiny.run_cell(name, trace)
    json.dumps(out)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] % 4 == 0 and out["attempted"] >= 4
    if trace:
        host = tiny.cell(name).mix["batches_on"] == "host"
        assert set(out["metrics"]) == (
            {"newton_iters.fit", "host_copy_share.fit"} if host
            else {"newton_iters.fit"})
        assert out["device"]["busy_s"] == 0.0
        assert out["breakdown"]["device_ops"] == []
    else:
        assert set(out["metrics"]) >= {"fits_per_s", "setup_s"}
