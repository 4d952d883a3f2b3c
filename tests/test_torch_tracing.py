"""PyTorch port, core/tracing: spans recorded only under torch.profiler, on its
clock, with their parents per thread; the bounded buffer; the counters; and
the six spans that the program opens at its layer boundaries. This file
imports no JAX, so its `cuda` case runs on the card with `--noconftest`."""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from construction_clip_tpu_torch.core import tracing


def _since(t0: int) -> list:
    return tracing.spans(t0)


def test_nothing_is_recorded_without_a_profiler():
    t0 = time.time_ns()
    with tracing.span("a"):
        with tracing.span("b"):
            torch.ones(4).sum()
    assert tracing.span("a") is tracing.span("b")   # the one shared null context
    assert _since(t0) == []


def test_parents_nest_on_a_thread_and_stay_apart_across_threads():
    t0 = time.time_ns()
    go = threading.Barrier(2, timeout=30)

    def work(tag):
        go.wait()
        with tracing.span(f"outer.{tag}"):
            go.wait()
            with tracing.span(f"inner.{tag}"):
                go.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("main"):
            with tracing.span("child"):
                pass
        threads = [threading.Thread(target=work, args=(tag,)) for tag in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in _since(t0)}
    assert set(got) == {"main", "child", "outer.x", "inner.x", "outer.y", "inner.y"}
    assert got["child"].parent == "main" and got["main"].parent is None
    for tag in "xy":
        assert got[f"outer.{tag}"].parent is None
        assert got[f"inner.{tag}"].parent == f"outer.{tag}"
        assert got[f"inner.{tag}"].thread == got[f"outer.{tag}"].thread
    assert got["outer.x"].thread != got["outer.y"].thread != got["main"].thread
    for s in got.values():
        assert t0 <= s.start_ns <= s.end_ns
    assert got["main"].start_ns <= got["child"].start_ns <= got["child"].end_ns \
        <= got["main"].end_ns


def test_spans_share_the_profilers_clock():
    """A record_function event lies within the span that encloses it."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with record_function("inside"):
                torch.ones(64).sum()
    (s,) = _since(t0)
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


@pytest.mark.cuda
def test_spans_record_under_a_device_only_profile():
    """Under activities=[CUDA] alone, as the benchmark profiles, spans still
    record, and the kernel launch call made inside one lies within it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the profile records the card's activity")
    x = torch.ones(1 << 16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                (x * 2).sum()
        torch.cuda.synchronize()
    got = {s.name: s for s in _since(t0)}
    assert set(got) == {"outer", "inner"} and got["inner"].parent == "outer"
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    inner = got["inner"]
    assert any(inner.start_ns <= a and b <= inner.end_ns for a, b in launches), launches


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "_SPANS", type(tracing._SPANS)(maxlen=8))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(20):
            with tracing.span(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == [f"s{i}" for i in range(12, 20)]
    assert tracing._SPANS.maxlen == 8 and tracing.MAX_SPANS >= 4096


def test_spans_overlapping_an_interval():
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("a", "b", "c"):
            with tracing.span(name):
                time.sleep(0.002)
    a, b, c = _since(t0)
    assert [s.name for s in tracing.spans(b.start_ns, b.end_ns)] == ["b"]
    assert [s.name for s in tracing.spans(a.end_ns - 1, c.start_ns + 1)] == ["a", "b", "c"]
    assert tracing.spans(c.end_ns + 1) == []


def test_counters_are_a_snapshot():
    tracing.count("test.snapshot")
    snap = tracing.counters()
    tracing.count("test.snapshot", 2)
    assert tracing.counters()["test.snapshot"] == snap["test.snapshot"] + 2
    snap["test.snapshot"] = -1
    assert tracing.counters()["test.snapshot"] > 0
    assert "test.never" not in tracing.counters()


def test_counting_from_many_threads_loses_nothing():
    """More threads than cores, switching every microsecond: no lost update."""
    threads, each = 16, 2000
    start = tracing.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [tracing.count("test.threads")
                                                    for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert tracing.counters()["test.threads"] - start == threads * each


def test_the_programs_six_spans_and_their_parents():
    """preprocess_batch, encode_image under make_process's batch function, its
    readback, and a tiny make_train_step step with its forward (the image
    tower inside it), backward and optimizer."""
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.apps.predict_zeroshot import make_process
    from construction_clip_tpu_torch.core.configs import CLIPConfig
    from construction_clip_tpu_torch.data.preprocess import preprocess_batch
    from construction_clip_tpu_torch.train.contrastive import make_train_step
    from construction_clip_tpu_torch.train.state import TrainState, make_adamw

    cfg = CLIPConfig.tiny()
    size, b = cfg.vision.image_size, 3
    rng = np.random.default_rng(0)
    staged = rng.integers(0, 256, (b, size + 8, size + 8, 3), dtype=np.uint8)
    params = convert.to_params(convert.init_clip(0, cfg), trainable=True)
    feats = torch.nn.functional.normalize(torch.randn(4, cfg.vision.embed_dim), dim=-1)
    names = [f"label_{i}" for i in range(4)]
    process = make_process(params.tree(), cfg, feats, names, "violation_type",
                           torch.device("cpu"))
    anns = [types.SimpleNamespace(id=i, file_name=f"{i}.jpg", violation_type=None)
            for i in range(b)]
    tx = make_adamw(1e-5, warmup_steps=0, total_steps=10)
    step = make_train_step(cfg, tx)
    state = TrainState.create(params, tx)
    tokens = torch.from_numpy(rng.integers(1, cfg.text.vocab_size, (b, cfg.text.context_length)))

    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        records, _ = process(anns, staged)
        t1 = time.time_ns()
        images = preprocess_batch(staged, size)
        state, _ = step(state, {"images": images, "tokens": tokens})
    assert len(records) == b
    served = [(s.name, s.parent) for s in tracing.spans(t0, t1)]
    assert served == [("preprocess", None), ("tower.image", None), ("readback", None)]
    trained = [(s.name, s.parent) for s in tracing.spans(t1)]
    # a span is recorded when it closes: the tower before the forward around it
    assert trained == [("preprocess", None), ("tower.image", "forward"), ("forward", None),
                       ("backward", None), ("optimizer", None)]
