"""One run of one cell: set-up, the measured window, the metrics, the check,
and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``readings``, every number the check read, and last
``checks``: each compared number beside its limit); the compared numbers
are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys

import torch

import engines
from harness import cell as cell_mod
from harness import check as check_mod
from harness import common
from harness import traffic as traffic_mod
from harness.trace import GAT_BACKWARD, GAT_FORWARD

PEAK_BF16_FLOPS = 989e12        # H100 SXM, dense, NVIDIA's data sheet
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BANNED = ("jax", "jaxlib", "flax", "graphvqa_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``graphvqa_tpu_torch`` is not ``graphvqa_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def read_metric(name: str, run) -> object:
    """The value of metric ``name`` from its reader,
    ``benchmark/metrics/<name>.py``; None when it finds nothing to read."""
    path = cell_mod.ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def card_state() -> str:
    """The card's clocks, temperature, power draw and active throttle
    reasons as ``nvidia-smi`` reads them (read after the window)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
             "temperature.gpu,power.draw,clocks_throttle_reasons.active",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def host_probe_ms() -> float:
    """Milliseconds the host takes for a fixed piece of Python: a slow host
    core shows here."""
    import time
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sum(i * i for i in range(300_000))
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def measure(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, hooks=None, man: dict = None,
            overrides=None) -> tuple:
    """Run the cell -> (Window, Setup, manifest entry). ``overrides``
    (tests) edits the configuration and traffic dicts before use."""
    from harness import eval_cell, train_cell
    man = man or cell_mod.manifest()
    wl = cell_mod.workload(workload, man)
    cfg_file = cell_mod.config_file(wl["config"], man)
    traffic = traffic_mod.load_traffic(wl["traffic"])
    if overrides is not None:
        cfg_file, traffic = overrides(cfg_file, traffic)
    # a configuration whose engine has no file stops before set-up
    engines.load(cfg_file["model"]["engine"]["kind"])
    if traffic.get("ranks", 1) > 1:
        from harness import dp_cell
        out, s = dp_cell.run(cfg_file, traffic, seed, seconds, trace, device,
                             t_start, hooks)
        return out, s, wl
    cfg = cell_mod.port_config(cfg_file, traffic)
    s = common.prepare(cfg, cfg_file, traffic, seed)
    try:
        runner = {"train": train_cell, "eval": eval_cell}[traffic["mode"]]
        out = runner.run(s, seed, seconds, trace, device, t_start, hooks)
    finally:
        common.cleanup(s)
    return out, s, wl


def rank_rows(s, seed: int, n_data: int, rank: int, steps: int) -> list:
    """The rows of data rank ``rank``'s first ``steps`` window batches: its
    shard of the epochs from epoch 0, as ``iter_batches`` yields them."""
    tr, out, epoch = s.traffic, [], 0
    while len(out) < steps:
        out += [list(idx) for idx in s.dataset.batch_order(
            s.cfg.batch, shuffle=True, seed=seed + epoch, drop_last=True,
            size_bucket_windows=tr["size_bucket"], shard_index=rank,
            num_shards=n_data)]
        epoch += 1
    return out[:steps]


def fill_counts(out, s, seed: int) -> None:
    """The operation count of the window's batches on every rank (all of
    the window, and its host part) and the least bytes of the engine's
    kernels over the traced steps."""
    from counts.flops import batch_flops
    cfg = s.cfg
    train = out.mode == "train"
    model_cfg = s.cfg_dict["model"]

    def rows(meta):
        return [int(q) for q in meta["question_ids"][:meta["real_count"]]]

    def flops(batches):
        return sum(batch_flops(model_cfg, common.batch_counts(
            s.reader, r, train, cfg), train) for r in batches)
    n_data = s.traffic.get("ranks", 1)
    per_rank = [[rows(m) for m in out.metas]] + [
        rank_rows(s, seed, n_data, r, out.steps) for r in range(1, n_data)]
    out.flops = sum(flops(b) for b in per_rank)
    out.host_flops = sum(flops(b[:out.host_steps]) for b in per_rank)
    kernel_bytes = getattr(engines.load(model_cfg["engine"]["kind"]),
                           "kernel_bytes", None)
    if out.trace_metas and kernel_bytes is not None:
        out.gat_bytes = kernel_bytes(model_cfg, [
            common.batch_counts(s.reader, rows(m), train, cfg)
            for m in out.trace_metas], train)


def evaluate(out, s, wl, seed, device) -> tuple:
    """(correct, rows of (name, value, limit), every number read) of the
    run's check."""
    lim = check_mod.limits(wl["name"])
    if out.mode == "train":
        prog = check_mod.program_train_numbers(out.check)
        ref = check_mod.reference_train(s, out.shapes, out.check["steps"],
                                        seed, device)
        detail = {}
        numbers = check_mod.train_numbers(prog, ref, detail)
        for k, worst in detail.items():
            log(f"worst {k} leaves: " + ", ".join(
                f"{n} {g:.4g}" for n, g in worst))
        log("readings: " + ", ".join(f"{k} {v!r}" for k, v in
                                      numbers.items()))
    else:
        numbers = check_mod.eval_numbers(s, out.shapes, out.check, seed,
                                         device)
        log("readings: " + ", ".join(f"{k} {v!r}" for k, v in
                                      numbers.items()))
    return check_mod.judge(numbers, lim) + (numbers,)


def result(workload, seed, seconds, trace, device, t_start, hooks=None,
           man=None, overrides=None) -> dict:
    man = man or cell_mod.manifest()
    out, s, wl = measure(workload, seed, seconds, trace, device, t_start,
                         hooks, man, overrides)
    if device.type == "cuda":
        log(f"after the window: card {card_state()}; host probe "
            f"{host_probe_ms():.2f} ms")
    out.chips = wl["chips"]
    out.peak_flops = PEAK_BF16_FLOPS
    out.peak_bytes_per_s = PEAK_BYTES_PER_S
    out.gat_kernels = (GAT_FORWARD, GAT_BACKWARD)
    fill_counts(out, s, seed)
    if out.trace:
        log(f"traced: {len(out.trace_metas)} steps, {out.trace['ops']} device "
            f"operations, GAT least bytes {out.gat_bytes}; " + ", ".join(
                f"{k} {v:.6f}s" for k, v in out.trace["kernel_s"].items()
                if "gat" in k.lower()))
    if out.batch_s:
        by_rung = {}
        for meta, t in zip(out.metas, out.batch_s):
            rows = [int(q) for q in meta["question_ids"][:meta["real_count"]]]
            by_rung.setdefault(s.reader.shape(
                rows, s.cfg.batch.nodes_per_graph,
                s.cfg.batch.edges_per_graph), []).append(1e3 * t)
        log(f"{len(out.batch_s)} eval batches; ms by rung (count, median, "
            f"max): " + ", ".join(
                f"{k} ({len(v)}, {sorted(v)[len(v) // 2]:.2f}, {max(v):.2f})"
                for k, v in sorted(by_rung.items())))
    if out.compiled_in_window:
        log(f"{out.compiled_in_window} batch shapes warmed up inside the "
            f"window")
    metrics = {}
    for m in cell_mod.metrics_of(wl, trace, man):
        v = read_metric(m["name"], out)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, rows, numbers = evaluate(out, s, wl, seed, device)
    correct = correct and not out.compiled_in_window
    res = {"correct": bool(correct), "attempted": out.steps, "failed": 0,
           "metrics": metrics,
           "device": device_info(device, out, wl)}
    if trace and out.trace is not None:
        res["device"]["busy_s"] = out.trace["busy_s"]
        res["device"]["window_s"] = out.trace["window_s"]
        res["breakdown"] = {"device_ops": out.trace["device_ops"],
                            "idle_gaps": out.trace["idle_gaps"]}
    res["readings"] = numbers
    res["checks"] = {k: {"value": v, "limit": l} for k, v, l in rows}
    return res


def device_info(device, out, wl) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": wl["chips"], "memory_peak_bytes": out.memory_peak,
            "power": power_limit()}


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    wl = cell_mod.workload(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the port on the card")
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        log(f"{args.workload} needs {wl['chips']} cards, have "
            f"{torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    res = result(args.workload, args.seed, args.seconds, bool(args.trace),
                 device, t_start)
    found = banned_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 3
    for k, c in res["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0
