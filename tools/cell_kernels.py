#!/usr/bin/env python3
"""One run of a benchmark cell as ``benchmark/trace_program.py`` runs it (the
program's tracing on), then what its traced sub-window held per step: the
device operations, the busy ms, the program's segments and the device ms of
each kernel name (the ten largest and every name containing --match).

    python3 tools/cell_kernels.py --workload gat.eval.gqa_b200 --seed 7 \
        --seconds 20 --trace 1 [--match layer_norm]

Prints ``run.py``'s result line, then ``{"cell_kernels": {...}}``. Needs
``--trace 1`` and the card.
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "benchmark"))

import trace_program as tp  # noqa: E402  (sets the benchmark's paths)


def main(argv) -> int:
    match = "layer_norm"
    if "--match" in argv:
        i = argv.index("--match")
        match = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    from graphvqa_tpu_torch.core import profiling
    profiling.enable(True)
    tp.train_cell.Tracer = tp.eval_cell.Tracer = tp.tracer
    rc = tp.main.main(argv, tp.T_START)
    run = tp.TRACERS[-1] if tp.TRACERS else None
    if run is None or not run.summary:
        print(json.dumps({"cell_kernels": None}), flush=True)
        return rc or 1
    s, steps = run.summary, len(run.metas)
    per = {n: 1e3 * t / steps for n, t in s["kernel_s"].items()}
    top = sorted(per, key=per.get, reverse=True)[:10]
    matched = {n: v for n, v in per.items() if match in n}
    print(json.dumps({"cell_kernels": dict(
        steps=steps, ops_per_step=s["ops"] / steps,
        busy_ms_per_step=1e3 * s["busy_s"] / steps,
        window_s=s["window_s"], segments_ms=s.get("segments_ms"),
        top_ms_per_step={n: round(per[n], 4) for n in top},
        match=match, matched_ms_per_step=round(sum(matched.values()), 4),
        matched={n: round(v, 4) for n, v in matched.items()})}),
        flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
