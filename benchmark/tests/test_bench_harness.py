"""The harness's arithmetic and its data: traffic by seed, the window's
metrics, the operation and byte counts, the import check, and a cell added
as files alone."""
import json
import math
import shutil
import subprocess
import sys

import numpy as np
import pytest

from counts.flops import forward_flops
from counts.gat_bytes import backward_bytes, forward_bytes
from harness import cell, common, traffic
from harness.main import banned_modules, read_metric

TRAIN = traffic.load_traffic("gqa_train_b200")


def small(mix, questions=240, scenes=30):
    return dict(mix, questions=questions, scenes=scenes)


def test_traffic_is_fixed_by_the_seed():
    a = traffic.make_split(small(TRAIN), 2**31 + 11)
    b = traffic.make_split(small(TRAIN), 2**31 + 11)
    c = traffic.make_split(small(TRAIN), 5)
    assert json.dumps(a) == json.dumps(b)
    assert json.dumps(a) != json.dumps(c)


def test_every_seed_has_the_same_graph_sizes():
    def sizes(seed):
        qs, scenes = traffic.make_split(small(TRAIN), seed)
        per_q = sorted(len(scenes[q[0]]["objects"]) for q in qs)
        rels = sorted(sum(len(o["relations"]) for o in s["objects"].values())
                      for s in scenes.values())
        return per_q, rels
    assert sizes(1) == sizes(2**31 + 99)


def test_the_object_counts_have_a_gqa_like_tail():
    _, scenes = traffic.make_split(TRAIN, 3)
    n = np.sort([len(s["objects"]) for s in scenes.values()])
    assert 12 <= n[len(n) // 2] <= 20
    assert 0.002 <= (n > 64).mean() <= 0.02


def window(**kw):
    w = common.Window(mode=kw.pop("mode", "train"))
    for k, v in kw.items():
        setattr(w, k, v)
    return w


def test_a_rate_is_over_the_whole_window():
    w = window(questions=1000, window_s=4.0, steps=5)
    assert read_metric("train_qa_per_s", w) == 250.0
    assert read_metric("eval_qa_per_s", w) is None
    w = window(mode="eval", questions=600, window_s=2.0)
    assert read_metric("eval_qa_per_s", w) == 300.0


def test_the_tail_is_the_p95_of_all_batches():
    batches = [0.010] * 190 + [0.050] * 10
    w = window(mode="eval", batch_s=batches)
    assert read_metric("eval_batch_p95_ms", w) == pytest.approx(10.0)
    w = window(mode="eval", batch_s=[0.010] * 189 + [0.050] * 11)
    assert read_metric("eval_batch_p95_ms", w) == pytest.approx(50.0)


def test_shares_of_the_window_and_of_the_peak():
    w = window(host_s=10.0, host_flops=989e12, chips=1, peak_flops=989e12)
    assert read_metric("data_wait_pct.train", w) is None
    assert read_metric("mfu.train", w) == pytest.approx(10.0)
    w.trace = dict(busy_s=0.9, window_s=1.0, ops=10, host_launches=40,
                   kernel_s={"gat_round_kernel(Params)": 0.002},
                   data_wait_idle_s=0.05)
    assert read_metric("data_wait_pct.train", w) == pytest.approx(5.0)
    w.trace_metas = [{}] * 20
    w.gat_bytes, w.gat_kernels = (3.35e9, 0), ("gat_round_kernel",
                                             "gat_round_backward_kernel")
    w.peak_bytes_per_s = 3.35e12
    assert read_metric("device_idle_pct.train", w) == pytest.approx(10.0)
    assert read_metric("host_launches_per_step.train", w) == 2.0
    assert read_metric("gat_round_roofline.train", w) == pytest.approx(50.0)
    assert read_metric("gat_round_backward_roofline.train", w) is None


def test_the_data_wait_counts_only_idle_time():
    """A wait in ``next()`` counts where no device operation runs: its
    part under the previous step's kernels does not."""
    import types
    from torch.autograd import DeviceType
    from harness.trace import NEXT_BATCH, summarize

    def ev(name, start, end, dev):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(start=start, end=end))
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    prof = types.SimpleNamespace(events=lambda: [
        ev("step", 0, 100, cpu), ev(NEXT_BATCH, 100, 400, cpu),
        ev("kernel", 10, 300, cuda), ev("cudaGraphLaunch", 400, 410, cpu),
        ev("kernel", 420, 900, cuda), ev(NEXT_BATCH, 850, 1000, cpu),
        ev(NEXT_BATCH, 880, 990, cuda)])
    t = summarize(prof, 1e-3)
    # idle 0-10, 300-420, 900-1000 (the span's mirror on the device is no
    # device work); waiting 100-400 and 850-1000
    assert t["data_wait_idle_s"] == pytest.approx(200e-6)
    assert t["busy_s"] == pytest.approx(770e-6)


def test_gat_bounds_hold_the_recorded_main_batch():
    """The (64, 256) B=512 batch of the port's kernel checks: 44.03 MB
    forward (bf16, with ins) and 113.35 MB backward (with the dropout
    scale), as the recorded kernel table states."""
    rng = np.random.default_rng(0)
    ns = nd = ne = 0
    for _ in range(512):
        n = max(2, int(rng.normal(17, 6)))
        e = n + max(n, int(rng.normal(90, 25)))
        rng.integers(2, 2000, size=(n, 12))
        src, dst = rng.integers(0, n, size=e), rng.integers(0, n, size=e)
        rng.integers(2, 2000, size=(e, 1))
        rng.random(e)
        ns, nd, ne = ns + len(np.unique(src)), nd + len(np.unique(dst)), \
            ne + e
    args = (512, 64, 256, 4, 300, 2, ns, nd, ne)
    assert round(forward_bytes(*args) / 1e6, 2) == 44.03
    assert round(backward_bytes(*args, with_keep=True) / 1e6, 2) == 113.35
    # a bigger rung moves more: the output and gradients are written whole
    assert forward_bytes(512, 128, 512, 4, 300, 2, ns, nd, ne) > \
        forward_bytes(*args)


def test_the_operation_count_of_a_linear_stack():
    cfg = json.loads((cell.ROOT / "configs" / "gat.json").read_text())
    m = cfg["model"]
    one = forward_flops(m, [10], [[4] * 5], [17], [60], greedy=False)
    two = forward_flops(m, [10, 10], [[4] * 5] * 2, [17] * 2, [60] * 2,
                        greedy=False)
    assert two == pytest.approx(2 * one)
    more = forward_flops(m, [10], [[4] * 5], [18], [60], greedy=False)
    # one more node: the engine's projections, the encoder's node MLP and
    # the pooling, each 2*k*n per row
    D, C, H, R = 512, 300, 4, 5
    per_node = (2 * 600 * 300 + 2 * 300 * 300
                + R * (2 * C * (H * C + 2 * H) + 2 * H * C)
                + 2 * C * D + 2 * D * D + 2 * D * D + 2 * D)
    assert more - one == pytest.approx(per_node)
    assert forward_flops(m, [10], [[15] * 5], [17], [60], greedy=True) > \
        forward_flops(m, [10], [[15] * 5], [17], [60], greedy=False)


def test_banned_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "graphvqa_tpu_torch_x", sys)
    assert "graphvqa_tpu" not in banned_modules()
    monkeypatch.setitem(sys.modules, "graphvqa_tpu.config", sys)
    assert banned_modules() == ["graphvqa_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    import ast
    for path in [*(cell.ROOT / "reference").glob("*.py"),
                 *(cell.ROOT / "engines").glob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "graphvqa_tpu", "graphvqa_tpu_torch", "jax", "harness"), \
                    (path.name, n)


def test_a_run_loads_no_jax(tiny, tmp_path):
    """A whole tiny run on the CPU in a fresh process, then its modules."""
    code = f"""
import sys, time, json, torch
sys.path.insert(0, {str(cell.ROOT)!r}); sys.path.append({str(cell.CHECKOUT)!r})
sys.path.insert(0, {str(cell.ROOT / 'tests')!r})
from conftest import shrink
from harness import main
res = main.result("gat.train.gqa_b200", 3, 1.0, False, torch.device("cpu"),
                  time.perf_counter(), overrides=shrink)
print(json.dumps([res["correct"], main.banned_modules()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(__import__("os").environ,
                                  TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    correct, banned = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and banned == []


def test_a_cell_added_as_files_is_found(tmp_path, tiny):
    """A throwaway cell: a traffic file, a limits file and a manifest
    entry in a copy of the benchmark, no file of it edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(cell.ROOT, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((cell.CHECKOUT / "BENCHMARK.json").read_text())
    mix = json.loads((cell.ROOT / "traffic" / "gqa_train_b200.json")
                     .read_text())
    mix["workers"] = 0
    (copy / "benchmark" / "traffic" / "gqa_train_b200_inproc.json") \
        .write_text(json.dumps(mix))
    (copy / "benchmark" / "limits" / "gat.train.gqa_b200_inproc.json") \
        .write_text((cell.ROOT / "limits" / "gat.train.gqa_b200.json")
                    .read_text())
    man["workloads"].append({"name": "gat.train.gqa_b200_inproc",
                             "config": "gat", "traffic":
                             "gqa_train_b200_inproc", "chips": 1,
                             "why": "collate in the main process"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "gat.train.gqa_b200" in m.get("workloads", []):
            m["workloads"].append("gat.train.gqa_b200_inproc")
    (copy / "BENCHMARK.json").write_text(json.dumps(man))
    code = f"""
import sys, time, json, torch
sys.path.insert(0, {str(copy / 'benchmark' / 'tests')!r})
sys.path.append({str(cell.CHECKOUT)!r})
from conftest import shrink
from harness import main
res = main.result("gat.train.gqa_b200_inproc", 4, 1.0, False,
                  torch.device("cpu"), time.perf_counter(), overrides=shrink)
print(json.dumps(res))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(__import__("os").environ,
                                  TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and "train_qa_per_s" in res["metrics"]
    assert math.isfinite(res["metrics"]["setup_s"]["value"])


def test_an_engine_is_found_by_its_file(tmp_path, tiny):
    """In a copy of the benchmark without ``engines/lcgn.py`` the lcgn cell
    stops before set-up, naming the file to add; with the file back the
    same copy runs correct."""
    copy = tmp_path / "checkout"
    shutil.copytree(cell.ROOT, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(cell.MANIFEST, copy / "BENCHMARK.json")
    engine = copy / "benchmark" / "engines" / "lcgn.py"
    kept = engine.read_text()
    engine.unlink()
    code = f"""
import sys, time, json, torch
sys.path.insert(0, {str(copy / 'benchmark' / 'tests')!r})
sys.path.append({str(cell.CHECKOUT)!r})
from conftest import shrink
from harness import main
res = main.result("lcgn.train.gqa_b200", 4, 1.0, False, torch.device("cpu"),
                  time.perf_counter(), overrides=shrink)
print(json.dumps(res))
"""

    def run():
        return subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=600,
                              env=dict(__import__("os").environ,
                                       TMPDIR=str(tmp_path)))
    out = run()
    assert out.returncode != 0
    assert "add benchmark/engines/lcgn.py" in out.stderr, out.stderr[-3000:]
    assert "set-up:" not in out.stderr
    engine.write_text(kept)
    out = run()
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
