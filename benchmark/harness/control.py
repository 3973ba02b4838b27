"""Readings that set a cell's limits: the control (the reference put in the
program's place, its products rounded to float8 e4m3, the precision below
the configuration's bfloat16), for a training cell the fault of half of
each batch left out, and a witness: the reference in the configuration's
own bfloat16, which shows what that precision alone reads against float32.
Not part of a benchmark run.

    python3 benchmark/harness/control.py --workload <cell> --seeds 1,2,3

Training cells need no program run: the control and the fault follow the
same three steps as the float32 reference (with several ranks, also the
fault of the exchange between them left out: rank 0's own gradient in
place of their mean). Validation cells run the cell
(``--seconds``) and read, at every position of the served prompts and
tokens, the gap of the token the lower precision puts first. Prints one
JSON line per seed, with each number's worst leaves for training.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.append(str(pathlib.Path(__file__).resolve().parents[2]))

from harness import cell as cell_mod  # noqa: E402
from harness import check as check_mod  # noqa: E402
from harness import common  # noqa: E402
from harness import main as main_mod  # noqa: E402
from harness import traffic as traffic_mod  # noqa: E402
from harness import train_cell  # noqa: E402


def train_readings(workload, seed, device, overrides=None) -> dict:
    man = cell_mod.manifest()
    wl = cell_mod.workload(workload, man)
    cfg_file = cell_mod.config_file(wl["config"], man)
    traffic = traffic_mod.load_traffic(wl["traffic"])
    if overrides is not None:
        cfg_file, traffic = overrides(cfg_file, traffic)
    cfg = cell_mod.port_config(cfg_file, traffic)
    s = common.prepare(cfg, cfg_file, traffic, seed)
    try:
        from graphvqa_tpu_torch.models.pipeline import PipelineModel
        with torch.device("meta"):
            shapes = common.leaf_shapes(PipelineModel(cfg.model))
        n_data = traffic.get("ranks", 1)
        plans = train_cell.plan_steps(s, seed, 1.0, n_data)
        steps = [[p[k] for p in plans]
                 for k in range(train_cell.CHECK_STEPS)]
        t0 = time.perf_counter()
        ref = check_mod.reference_train(s, shapes, steps, seed, device)
        ref_s = time.perf_counter() - t0
        out = {"seed": seed, "reference_s": ref_s}
        cases = [("control_fp8", dict(precision="fp8")),
                 ("fault_half_batch", dict(fault="half_batch")),
                 ("witness_bf16", dict(precision="bf16"))]
        if n_data > 1:
            cases.append(("fault_no_exchange", dict(fault="no_exchange")))
        for name, kw in cases:
            got = check_mod.reference_train(s, shapes, steps, seed, device,
                                            **kw)
            detail = {}
            out[name] = check_mod.train_numbers(got, ref, detail)
            out[name + "_worst"] = detail
        return out
    finally:
        common.cleanup(s)


def eval_readings(workload, seed, seconds, device, overrides=None) -> dict:
    t_start = time.perf_counter()
    out, s, wl = main_mod.measure(workload, seed, seconds, False, device,
                                  t_start, overrides=overrides)
    prog = check_mod.eval_numbers(s, out.shapes, out.check, seed, device)
    ctrl = check_mod.eval_numbers(s, out.shapes, out.check, seed, device,
                                  precision="fp8")
    witness = check_mod.eval_numbers(s, out.shapes, out.check, seed, device,
                                     precision="bf16")
    return {"seed": seed, "program": prog, "control_fp8": ctrl,
            "witness_bf16": witness}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the readings are taken on the card")
    device = torch.device("cuda", 0)
    mode = traffic_mod.load_traffic(cell_mod.workload(args.workload)[
        "traffic"])["mode"]
    for seed in (int(x) for x in args.seeds.split(",")):
        if mode == "train":
            r = train_readings(args.workload, seed, device)
        else:
            r = eval_readings(args.workload, seed, args.seconds, device)
        print(json.dumps(dict(r, workload=args.workload)), flush=True)
        common.free(device)


if __name__ == "__main__":
    main()
