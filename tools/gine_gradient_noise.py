#!/usr/bin/env python3
"""Which leaves of the GINE cell's bfloat16 gradient move between two eager
runs of the same step, and what the float32 reference says they should be.

    python3 tools/gine_gradient_noise.py [--workload gine.train.gqa_b200] \
        [--seed 7]

Builds the cell's model twice from the benchmark's weights and runs one
eager train step on each (the cell's first main-rung batch, the same
dropout and context generators; deterministic algorithms off, so the
backward's atomic sums fall in any order). Per leaf: the largest difference
of the two gradients over the first's largest |element| ("of a tensor's
scale") and the norm of the difference over the first's norm. For the
leaves that move most, and for every round's ``convs.N.nn.2.bias``: the
float32 reference's first gradient norm (``benchmark/reference``, the
check's own), the program's, the median leaf's, and the check's
denominator, the larger of the reference leaf's norm and the median's.
Prints one JSON line. Needs the card.
"""
import json
import statistics
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
sys.path.insert(0, str(BENCH))
sys.path.append(str(BENCH.parent))

import torch  # noqa: E402

from harness import cell, check, common, train_cell  # noqa: E402
from harness.traffic import load_traffic  # noqa: E402


def eager_gradient(s, seed, batch, device) -> dict:
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    model, _ = common.build_model(s.cfg, seed + 1, device)
    state = create_train_state(model, lr=s.cfg.train.lr)
    step = make_train_step(model, s.cfg, capture=False)
    step(state, batch, torch.Generator(device=device).manual_seed(seed + 3),
         torch.Generator(device=device).manual_seed(seed + 2))
    out = {n: p.grad.detach().float().clone() if p.grad is not None
           else torch.zeros_like(p) for n, p in model.named_parameters()}
    del model, state, step
    common.free(device)
    return out


def main(argv) -> int:
    import argparse
    from graphvqa_tpu_torch.data.dataset import MAX_EXECUTION_STEP, build_batch
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="gine.train.gqa_b200")
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    wl = cell.workload(args.workload)
    cfg_file = cell.config_file(wl["config"])
    traffic = load_traffic(wl["traffic"])
    cfg = cell.port_config(cfg_file, traffic)
    s = common.prepare(cfg, cfg_file, traffic, args.seed)
    try:
        plan = train_cell.plan_steps(s, args.seed, 1.0)[0]
        (npg, epg), idx = plan[0]
        _, batch = build_batch(s.dataset, idx, cfg.batch, MAX_EXECUTION_STEP)
        batch = batch.to(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        g1 = eager_gradient(s, args.seed, batch, device)
        g2 = eager_gradient(s, args.seed, batch, device)
        scale = {n: float((g1[n] - g2[n]).abs().max())
                 / max(float(g1[n].abs().max()), 1e-30) for n in g1}
        norm = {n: float(torch.linalg.vector_norm(g1[n] - g2[n]))
                / max(float(torch.linalg.vector_norm(g1[n])), 1e-30)
                for n in g1}
        shapes = {n: tuple(t.shape) for n, t in g1.items()}
        ref = check.reference_train(s, shapes, [[plan[0]]], args.seed,
                                    device)
        ref_norm = ref["grad_norms"]
        med = statistics.median(ref_norm.values())
        top = sorted(scale, key=scale.get, reverse=True)[:8]
        biases = [n for n in g1 if ".convs." in n and n.endswith(
            ".nn.2.bias")]
        leaves = {}
        for n in dict.fromkeys(top + biases):
            prog = float(torch.linalg.vector_norm(g1[n]))
            dist = float(torch.linalg.vector_norm(
                g1[n] - ref["grads"][n].float())) / max(ref_norm[n], med)
            leaves[n] = dict(
                run_to_run_of_scale=scale[n], run_to_run_of_norm=norm[n],
                program_norm=prog, reference_norm=ref_norm[n],
                reference_over_median=ref_norm[n] / med,
                program_over_median=prog / med,
                check_denominator=max(ref_norm[n], med),
                grad_dist=dist)
        values = sorted(scale.values())
        print(json.dumps({"gine_gradient_noise": dict(
            workload=args.workload, seed=args.seed, rung=[npg, epg],
            median_leaf_reference_norm=med, leaves=len(g1),
            run_to_run_of_scale_median=values[len(values) // 2],
            leaves_above_a_tenth=sum(v > 0.1 for v in values),
            worst=leaves)}), flush=True)
    finally:
        common.cleanup(s)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
