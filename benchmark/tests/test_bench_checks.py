"""The correctness checks fail what they must: each fault that a cell can
have, planted under the harness, and the control (the reference one
precision below the configuration's, in the program's place)."""

import time

import pytest
import torch

import calibrate
import faults
import harness
import run
from test_bench_harness import run_cpu, tiny_checkout


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checks"))


@pytest.mark.parametrize("workload, fault", [
    ("tiny-train", "unchanged_state"), ("tiny-train", "half_batch"),
    ("tiny-train-fp32", "half_batch"), ("tiny-zeroshot", "altered_answer")])
def test_planted_fault_is_not_correct(checkout, capsys, workload, fault):
    with faults.FAULTS[fault]():
        rc, line = run_cpu(checkout, workload, capsys)
    assert rc == 0
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_float8_control_is_not_correct(checkout, seed):
    cell = harness.Cell("tiny-train", checkout, checkout / "benchmark")
    r, _ = run.run_once(cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert harness.judge(r.check(), cell.limits)[0]
    assert not harness.judge(r.control("fp8"), cell.limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vitb32-zeroshot-fp32", "vitb32-train-bf16",
                                      "vitl14-train-bf16"])
def test_controls_and_faults_on_the_card(workload):
    """At the cell's own size on the card: the program passes its limits, the
    control and every fault the cell can have fail them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = harness.Cell(workload)
    got = calibrate.readings(cell, 2_147_483_713, 2.0, torch.device("cuda", 0), True)
    assert harness.judge(got["program"], cell.limits)[0], got
    for key in ("control",) + calibrate.CELL_FAULTS[cell.loop().Run.kind]:
        assert not harness.judge(got[key], cell.limits)[0], (key, got[key])
