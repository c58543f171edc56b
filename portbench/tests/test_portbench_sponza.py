"""The sponza-4k-b1.render cell's comparison on the CPU: a whole run of
the cell, cut to a test's size (32x24, spheres of 24 x 48: 55,332
triangles, still on K6's path), reads ``correct`` on the program's
normal path and not with a fault planted (the faults of
test_portbench_faults.py, in the same copied checkout)."""

import pytest

from portbench.tests.test_portbench_faults import _run, checkout  # noqa: F401

WORKLOAD = "sponza-4k-b1.render"
FAULTS = (None, "unchanged", "half_batch", "altered")


@pytest.mark.parametrize("fault", FAULTS, ids=[f or "sound" for f in FAULTS])
def test_sponza_run_judges_the_timed_path(checkout, fault):  # noqa: F811
    result = _run(checkout, WORKLOAD, fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1
