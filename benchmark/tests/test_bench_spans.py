"""work/spans.py and the per-layer metrics that read the program's spans, on
a hand-made record: launch calls matched to kernels (a `cuLaunchKernel`
call inside a `cudaLaunchKernel` call counted once), kernels given to every span open at their
launch (nested ones and other threads' too), blocked time left out, spans
grouped by unit, and no device time where launches and kernels differ."""

import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile

import harness
from construction_clip_tpu_torch.core import tracing
from work import spans

MAIN = 1   # the step's thread
UNITS = [(0, 1000), (1000, 2000)]
SPANS = [tracing.Span("preprocess", None, MAIN, 50, 300),
         tracing.Span("inner", "tower.image", MAIN, 340, 400),
         tracing.Span("tower.image", None, MAIN, 300, 700),
         tracing.Span("readback", None, MAIN, 700, 900),
         tracing.Span("preprocess", None, MAIN, 1010, 1050),
         tracing.Span("forward", None, MAIN, 1050, 1400),
         tracing.Span("backward", None, MAIN, 1400, 1800),
         tracing.Span("optimizer", None, MAIN, 1800, 1990)]
RUNTIME = [(100, 110, "cudaLaunchKernel"),
           (120, 130, "cudaLaunchKernel"), (122, 128, "cuLaunchKernel"),    # one launch
           (140, 240, "cudaMemcpyAsync"),
           (310, 320, "cudaLaunchKernel"),
           (330, 340, "cuLaunchKernelEx"),       # inside no cudaLaunchKernel call
           (350, 360, "cudaLaunchKernelExC"),
           (710, 800, "cudaMemcpyAsync"), (800, 850, "cudaStreamSynchronize"),
           (950, 990, "cudaDeviceSynchronize"),
           (1100, 1110, "cudaLaunchKernel"),
           (1500, 1510, "cudaLaunchKernel"),    # autograd's thread, the step's in `backward`
           (1600, 1610, "cudaLaunchKernel"),
           (1620, 1630, "cudaEventRecord")]
LAUNCHED = [100, 120, 310, 330, 350, 1100, 1500, 1600]
# kernel i runs 2**i ns, after its launch, in launch order
KERNELS = [(f"k{i}", t + 500, 2 ** i) for i, t in enumerate(LAUNCHED)]
BLOCKED = [(230, 260, "Command Buffer Full")]


def _record(kernels=KERNELS, runtime=RUNTIME, units=UNITS):
    trace = types.SimpleNamespace(spans=list(units), runtime=sorted(runtime), kernels=kernels,
                                  blocked=BLOCKED, units=len(units))
    return types.SimpleNamespace(trace=trace)


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, fields in want.items():
        assert got[name] == pytest.approx(fields), name


@pytest.fixture
def program(monkeypatch):
    """SPANS in the place of the program's recorder."""
    monkeypatch.setattr(spans, "program_spans",
                        lambda lo, hi: [s for s in SPANS if lo <= s.start_ns and s.end_ns <= hi])


def test_cu_call_inside_a_cuda_call_is_one_launch():
    assert spans.launch_calls(RUNTIME) == LAUNCHED


def test_units_attribute_launches_kernels_and_blocked_time(program):
    u0, u1 = spans.units(_record())
    ns = 1e-6   # ms
    _same(u0, {
        # [50, 300) less the union of the copy [140, 240) and the full queue [230, 260)
        "preprocess": {"host_ms": 130 * ns, "wait_ms": 120 * ns, "launches": 2,
                       "device_ms": 3 * ns},
        # the cuLaunchKernelEx call alone at 330 is a launch of its own
        "tower.image": {"host_ms": 400 * ns, "wait_ms": 0.0, "launches": 3,
                        "device_ms": (4 + 8 + 16) * ns},
        # a nested span's kernel is its parent's too
        "inner": {"host_ms": 60 * ns, "wait_ms": 0.0, "launches": 1, "device_ms": 16 * ns},
        "readback": {"host_ms": 60 * ns, "wait_ms": 140 * ns, "launches": 0, "device_ms": 0.0}})
    _same(u1, {
        "preprocess": {"host_ms": 40 * ns, "wait_ms": 0.0, "launches": 0, "device_ms": 0.0},
        "forward": {"host_ms": 350 * ns, "wait_ms": 0.0, "launches": 1, "device_ms": 32 * ns},
        # launched on another thread while the step's thread waits in the span
        "backward": {"host_ms": 400 * ns, "wait_ms": 0.0, "launches": 2, "device_ms": 192 * ns},
        "optimizer": {"host_ms": 190 * ns, "wait_ms": 0.0, "launches": 0, "device_ms": 0.0}})


def test_spans_of_one_name_in_a_unit_add_up(program, monkeypatch):
    split = SPANS[:2] + [tracing.Span("tower.image", None, MAIN, 300, 340),
                         tracing.Span("tower.image", None, MAIN, 340, 700)] + SPANS[3:]
    monkeypatch.setattr(spans, "program_spans", lambda lo, hi: split)
    u0, _ = spans.units(_record())
    assert u0["tower.image"]["launches"] == 3
    assert u0["tower.image"]["host_ms"] == pytest.approx(400e-6)


def test_counts_that_differ_give_no_device_time(program):
    u0, u1 = spans.units(_record(kernels=KERNELS[:-1]))
    assert u0["tower.image"]["device_ms"] is None and u0["tower.image"]["launches"] == 3
    assert u1["forward"]["host_ms"] == pytest.approx(350e-6)
    assert spans.median(_record(kernels=KERNELS[:-1]), "forward", "device_ms") is None
    assert spans.median(_record(kernels=KERNELS[:-1]), "forward", "launches") == 1


def test_median_over_the_units_that_hold_the_span(program):
    assert spans.median(_record(), "preprocess", "launches") == 1       # 2 and 0
    assert spans.median(_record(), "preprocess", "host_ms") == pytest.approx(85e-6)
    assert spans.median(_record(), "readback", "host_ms") == pytest.approx(60e-6)
    assert spans.median(_record(), "no-such-span", "host_ms") is None


@pytest.mark.parametrize("metric, want", [
    ("preprocess_host_ms.zeroshot", 85e-6), ("preprocess_wait_ms.zeroshot", 60e-6),
    ("preprocess_device_ms.zeroshot", 1.5e-6), ("tower_host_ms.zeroshot", 400e-6),
    ("tower_launches.zeroshot", 3), ("readback_host_ms.zeroshot", 60e-6),
    ("preprocess_device_ms.train", 1.5e-6), ("forward_device_ms.train", 32e-6),
    ("backward_device_ms.train", 192e-6), ("optimizer_device_ms.train", 0.0),
    ("optimizer_launches.train", 0)])
def test_the_eleven_readers(metric, want, program):
    reader = harness.load_module(harness.BENCH / "metrics" / f"{metric}.py")
    assert reader.read(_record()) == pytest.approx(want)


def test_nothing_to_read_gives_none(program, monkeypatch):
    """No trace, no runtime calls (a run on the CPU), or a program that
    records no spans (one older than core/tracing.py)."""
    reader = harness.load_module(harness.BENCH / "metrics" / "forward_device_ms.train.py")
    assert reader.read(types.SimpleNamespace(trace=None)) is None
    assert reader.read(_record(runtime=[])) is None
    monkeypatch.setattr(spans, "program_spans", lambda lo, hi: None)
    assert reader.read(_record()) is None


def test_spans_come_from_the_programs_recorder():
    """Spans the program recorded under a profiler, read within the units'
    bounds; one outside them is left out."""
    with profile(activities=[ProfilerActivity.CPU]):
        lo = time.time_ns()
        with tracing.span("preprocess"):
            mid = time.time_ns()
        hi = time.time_ns()
        with tracing.span("preprocess"):
            pass
    record = _record(kernels=[("k", mid + 10, 7)], runtime=[(mid, mid + 1, "cudaLaunchKernel")],
                     units=[(lo, hi)])
    (unit,) = spans.units(record)
    assert unit["preprocess"]["launches"] == 1 and unit["preprocess"]["device_ms"] == 7e-6
