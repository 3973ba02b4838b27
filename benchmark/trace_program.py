#!/usr/bin/env python3
"""One run of one cell as ``benchmark/run.py`` runs it, with the port's own
tracing on (``graphvqa_tpu_torch/core/profiling.py``: its spans and the
device segments stamped inside its replayed steps), turned on before the
cell builds its step.

    python3 benchmark/trace_program.py --workload gat.train.gqa_b200 \
        --seed 7 --seconds 20 --trace 1

It prints ``run.py``'s result line, then one more JSON line,
``{"program_trace": ...}``: with ``--trace 1`` the traced sub-window's
segments per step and the idle time by the program's spans
(``harness/program_trace.py``), with ``--trace 0`` nothing but the
switch's state. Set beside ``run.py``'s run of the same cell and seed with
``--trace 0``, its ``train_qa_per_s`` / ``eval_qa_per_s`` give what
tracing costs when it is on.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = CHECKOUT / "build" / "benchmark_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path.insert(0, str(HERE))
sys.path.append(str(CHECKOUT))

from graphvqa_tpu_torch.core import profiling  # noqa: E402
from harness import eval_cell, main, train_cell  # noqa: E402
from harness.program_trace import ProgramTracer  # noqa: E402

TRACERS = []


def tracer(*args, **kwargs):
    TRACERS.append(ProgramTracer(*args, **kwargs))
    return TRACERS[-1]


if __name__ == "__main__":
    profiling.enable(True)
    train_cell.Tracer = eval_cell.Tracer = tracer
    rc = main.main(sys.argv[1:], T_START)
    summary = TRACERS[-1].summary if TRACERS else None
    keep = ("segments_ms", "idle_by_span", "step_call_idle_s", "busy_s",
            "window_s", "idle_gaps")
    print(json.dumps({"program_trace": dict(
        enabled=profiling.enabled(),
        **({k: summary[k] for k in keep} if summary else {}))}), flush=True)
    sys.exit(rc)
