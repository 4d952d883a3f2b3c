"""The harness on the CPU: cells, configurations, traffic mixes and metrics
found by name from a temporary directory; whole runs of small cells through
the program's plain kernel versions; the trace's reading and the attribution
of launches to functions."""

import json
import shutil
import time

import pytest

import harness
import run
import trace as tracing
from work import calls

TINY = {"name": "tiny", "source": "CLIPConfig.tiny of the port's core/configs.py",
        "reference": "clip", "reduced": [],
        "vision": {"image_size": 32, "patch_size": 8, "width": 64, "layers": 2, "heads": 2,
                   "embed_dim": 32},
        "text": {"vocab_size": 256, "context_length": 16, "width": 32, "layers": 2, "heads": 2,
                 "embed_dim": 32},
        "quick_gelu": True, "logit_scale_init": 2.6592, "param_dtype": "float32"}


# The tiny cells' own limits, from their readings on the CPU (seeds 5-7): the
# program reads up to 4.2e-3 / 3.5e-2 / 3.3e-2 in bf16, ~1e-6 in fp32; the
# float8 control from 3.4e-2 / 1.2e-1 / 6.3e-2
TINY_LIMITS = {"tiny-zeroshot": {"logprob_gap": 1e-4},
               "tiny-train": {"loss_gap": 1.2e-2, "grad_gap": 7e-2, "change_gap": 5e-2},
               "tiny-train-fp32": {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}}


def tiny_checkout(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ in tmp_path, with a tiny
    configuration and three cells on it added as new files and entries."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY))
    z = json.loads((bench / "traffic" / "zeroshot-closed-b32.json").read_text())
    z.update(batch=4, stage_size=40, pool_batches=2, labels=3, label_eot=[3, 8], trace_batches=3,
             check_batches=3)
    (bench / "traffic" / "tiny-zeroshot.json").write_text(json.dumps(z))
    t = json.loads((bench / "traffic" / "train-b108.json").read_text())
    t.update(batch=6, stage_size=40, pool_batches=4, eot=[3, 10], trace_steps=2, ref_rows=4)
    (bench / "traffic" / "tiny-train.json").write_text(json.dumps(t))
    (bench / "traffic" / "tiny-train-fp32.json").write_text(json.dumps(dict(t, precision="fp32")))
    spec["configs"].append({"name": "tiny", "source": "x", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "tests"})
    cells = {"tiny-zeroshot": "vitb32-zeroshot-fp32", "tiny-train": "vitb32-train-bf16",
             "tiny-train-fp32": "vitb32-train-bf16"}
    for name, like in cells.items():
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": name, "chips": 1,
                                  "why": "tests"})
        (bench / "limits" / f"{name}.json").write_text(json.dumps(TINY_LIMITS[name]))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


def run_cpu(root, workload, capsys, trace=0, seed=2_147_483_701, seconds=0.5):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], root=root, bench=root / "benchmark",
                  need_cuda=False, t0=time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


def test_cell_found_by_name(checkout):
    cell = harness.Cell("tiny-train", checkout, checkout / "benchmark")
    assert cell.config["vision"]["width"] == 64
    assert cell.traffic["batch"] == 6 and cell.traffic["loop"] == "train"
    assert {m["name"] for m in cell.end_to_end} == {"train_pairs_per_s", "setup_s"}
    assert "k1k3_roofline.train" in {m["name"] for m in cell.per_layer}
    assert "k1_roofline.zeroshot" not in {m["name"] for m in cell.per_layer}
    with pytest.raises(KeyError):
        harness.Cell("no-such-cell", checkout, checkout / "benchmark")


def test_new_metric_is_a_new_file(checkout, capsys):
    """A per-layer metric added as a reader file and an entry, nothing edited."""
    root = checkout.parent / "with_metric"
    shutil.copytree(checkout, root)
    (root / "benchmark" / "metrics" / "units_seen.zeroshot.py").write_text(
        "def read(record):\n    return record.units\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "units_seen.zeroshot", "unit": "batches", "better": "higher",
                              "source": "host_clock", "layer": "app batch and step loop",
                              "moves": "zeroshot_img_per_s", "workloads": ["tiny-zeroshot"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line = run_cpu(root, "tiny-zeroshot", capsys, trace=1)
    assert rc == 0
    assert line["metrics"]["units_seen.zeroshot"]["value"] == line["attempted"]


@pytest.mark.parametrize("workload", ["tiny-zeroshot", "tiny-train", "tiny-train-fp32"])
def test_cpu_run_end_to_end(checkout, capsys, workload):
    rc, line = run_cpu(checkout, workload, capsys)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    rate = "zeroshot_img_per_s" if "zeroshot" in workload else "train_pairs_per_s"
    assert line["metrics"][rate]["value"] > 0
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_cpu_trace_run_reports_host_metrics(checkout, capsys):
    rc, line = run_cpu(checkout, "tiny-train", capsys, trace=1)
    assert rc == 0
    assert "mfu.train" in line["metrics"]
    # no device here: the readers of the device and of its runtime calls find
    # nothing and their metrics are left out
    assert "k1k3_roofline.train" not in line["metrics"]
    assert "idle_share.train" not in line["metrics"]
    assert "enqueue_ms.train" not in line["metrics"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line


SQUARE_LOOP = """
import torch

import trace as tracing


class Run:
    kind = "square"

    def __init__(self, cfg, traffic, seed, device, trace):
        g = torch.Generator(device=device).manual_seed(seed)
        self.cfg, self.traffic, self.memory_peak = cfg, traffic, 0
        self.x = torch.randn(cfg["size"], cfg["size"], generator=g, device=device)
        self.cuda = device.type == "cuda"

    def _unit(self):
        self.y = self.x @ self.x

    def window(self, seconds, trace):
        record = tracing.drive(self._unit, seconds, self.cuda,
                               self.traffic["trace_units"] if trace else 0)
        vars(record).update(cfg=self.cfg, traffic=self.traffic, done=record.units,
                            trace=record.stretch.read() if record.stretch else None)
        return record

    def check(self):
        return {"gap": float((self.y - self.x.double() @ self.x.double()).abs().max())}
"""


def test_cell_of_another_system_needs_no_edit(checkout, capsys):
    """A cell whose configuration has no CLIP towers, with a loop, traffic,
    limits and metrics of its own, runs traced from new files and entries
    alone; the CLIP cells' kernel and device readers listed for it find
    nothing to read and are left out."""
    root = checkout.parent / "square"
    shutil.copytree(checkout, root)
    bench = root / "benchmark"
    (bench / "configs" / "square.json").write_text(json.dumps({"name": "square", "size": 48}))
    (bench / "traffic" / "square-loop.json").write_text(
        json.dumps({"loop": "square", "trace_units": 3}))
    (bench / "loops" / "square.py").write_text(SQUARE_LOOP)
    (bench / "limits" / "square-cell.json").write_text(json.dumps({"gap": 1e-3}))
    (bench / "metrics" / "products_per_s.py").write_text(
        "def read(record):\n    return record.done / record.window_s\n")
    (bench / "metrics" / "units_seen.square.py").write_text(
        "def read(record):\n    return record.units\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "square", "source": "x",
                            "file": "benchmark/configs/square.json", "reduced": [], "why": "t"})
    spec["workloads"].append({"name": "square-cell", "config": "square",
                              "traffic": "square-loop", "chips": 1, "why": "tests"})
    spec["end_to_end"].append({"name": "products_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["square-cell"]})
    spec["per_layer"].append({"name": "units_seen.square", "unit": "units", "better": "higher",
                              "source": "host_clock", "layer": "loop",
                              "moves": "products_per_s", "workloads": ["square-cell"]})
    for m in spec["per_layer"]:
        if m["name"] in ("k1k3_roofline.train", "idle_share.train", "enqueue_ms.train"):
            m["workloads"].append("square-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for trace in (0, 1):
        rc, line = run_cpu(root, "square-cell", capsys, trace=trace, seconds=0.3)
        assert rc == 0 and line["correct"] is True, line
        want = {"units_seen.square"} if trace else {"products_per_s", "setup_s"}
        assert set(line["metrics"]) == want
    assert line["metrics"]["units_seen.square"]["value"] == line["attempted"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def test_no_card_no_result(checkout, capsys):
    rc = run.main(["--workload", "tiny-zeroshot", "--seed", "1", "--seconds", "1", "--trace", "0"],
                  root=checkout, bench=checkout / "benchmark")
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name, want", [
    ("void cct::gemm_tc<1, false, 64, 128>(CUtensorMap, CUtensorMap, float const*)",
     "gemm_tc<1, false, 64, 128>"),
    ("void cct::(anonymous namespace)::tc_dq<true, 64>(CUtensorMap, cct::TcGeom)",
     "tc_dq<true, 64>"),
    ("ln_param_reduce(float const*, float*, float*, int, int)", "ln_param_reduce"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >"),
])
def test_short_name(name, want):
    assert tracing.short_name(name) == want


def test_attribute_shared_names_by_neighbours():
    """K3 and K5 share tc_stats and tc_dkv; K1 and K3 the row pass and gemm_tc."""
    seq = ["ln_rows<__nv_bfloat16>", "gemm_tc<1, false, 64, 128>",
           "tc_block_fwd<__nv_bfloat16, 64>",
           "gemm_tc<2, false, 64, 64>", "tc_fwd", "nvjet_tst_128x64",
           "tc_stats<64>", "tc_dq<false, 64>", "tc_dkv<64>", "sm90_xmma_gemm",
           "ln_rows<__nv_bfloat16>", "gemm_tc<1, false, 64, 128>", "gemm_tc<3, true, 64, 64>",
           "tc_stats<64>", "tc_dq<true, 64>", "tc_dkv<64>", "gemm_tc<0, true, 64, 64>",
           "ln_backward_rows<__nv_bfloat16>", "ln_param_partials<__nv_bfloat16>",
           "ln_param_reduce"]
    owner = calls.attribute([(n, i, 1) for i, n in enumerate(seq)], ["k1", "k3", "k4", "k5"])
    assert owner == ["k1"] * 4 + ["k4", None] + ["k5"] * 3 + [None] + ["k3"] * 10


def test_trace_read_busy_idle_and_gaps():
    host = [(350, 390, "cudaStreamSynchronize"), (500, 900, "cudaMemcpyAsync"),
            (600, 610, "Command Buffer Full")]
    device = [(50, 200, "void k(int)"), (150, 300, "void k(int)"), (800, 1200, "void j(float)"),
              (-50, 20, "void early()")]
    tr = tracing.read((host, device), 2, (0, 1000), [(100, 400), (400, 900)])
    assert tr.window_s == pytest.approx(1000e-9)
    assert tr.busy_s == pytest.approx((20 + 250 + 200) * 1e-9)   # [0,20), [50,300), [800,1000)
    gaps = dict(tr.idle_gaps)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(500e-9)         # [300, 800), mid 550
    assert gaps[tracing.HOST] == pytest.approx(30e-9)               # [20, 50)
    assert [n for n, _ in tr.device_ops] == ["k", "j", "early"]
    assert tr.spans == [(100, 400), (400, 900)]
    assert [n for _, _, n in tr.runtime] == ["cudaStreamSynchronize", "cudaMemcpyAsync"]
    assert tr.blocked == [(600, 610, "Command Buffer Full")]


def test_enqueue_train_leaves_out_blocked_time():
    """A step's span less the union of its copies, synchronises and CUPTI's
    records of a full launch queue."""
    import types

    from harness import load_module

    reader = load_module(harness.BENCH / "metrics" / "enqueue_ms.train.py")
    runtime = [(0, 10, "cudaLaunchKernel"), (20, 30, "cudaLaunchKernel"),
               (40, 240, "cudaLaunchKernel"), (300, 600, "cudaMemcpyAsync"),
               (950, 1050, "cudaStreamSynchronize"), (1100, 1110, "cudaLaunchKernel")]
    blocked = [(50, 230, "Command Buffer Full"), (500, 700, "Command Buffer Full")]
    trace = types.SimpleNamespace(runtime=runtime, blocked=blocked,
                                  spans=[(0, 1000), (1000, 2000)])
    got = reader.read(types.SimpleNamespace(trace=trace))
    # [0, 1000): 180 + [300, 700) + [950, 1000); [1000, 2000): [1000, 1050)
    assert got == pytest.approx(((1000 - 180 - 400 - 50) + (1000 - 50)) / 2 / 1e6)
