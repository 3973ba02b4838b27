#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphvqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build    nvcc builds csrc/gat_round.cu, csrc/gat_round_backward.cu,
              csrc/layer_norm.cu, csrc/gine_messages.cu,
              csrc/gine_messages_backward.cu, csrc/lcgn_linear.cu and
              csrc/lcgn_linear_backward.cu for sm_90a (first use, one nvcc
              per source, in parallel)
  2. kernel   the GAT-round kernel against its plain PyTorch version at the
              main path's shapes (B=512, npg=64, epg=256, H=4, C=300) on
              GQA-shaped random graphs: both softmax shifts, with and without
              the instruction share, f32 and bf16; max error; the kernel's
              device time (torch.profiler, median, cold L2) beside the
              least-bytes bound, the wrapper's host time per call, and the
              plain version's time (CUDA events, median); then the training
              options (dropout scale, attention output) against the twin
  3. backward the backward kernel against its plain version on the same
              batch (bf16 and f32, both shifts, with the share, with and
              without the dropout scale); device time, bound, the wrapper's
              host time per call, plain time, and the (graph, head) work
              units the kernel's counter handed out per launch
  4. parity   the full-width gat_config() model (random seeded weights,
              random BatchNorm statistics, bf16) on B=8, card against CPU
  5. serve    make_eval_step on 3 requests of B=512 at full width, each the
              replay of the step's CUDA graph (after the eager warm-up and
              the capture); the kernel must run exactly 5 times per request
              and the LayerNorm forward 357 times (each launch counts itself
              on the card; step_launches); ms per step and QA/s,
              capture seconds, peak memory; then two more replays, each
              against the eager step on its request (phase 4's limits)
  6. profile  where one more request's time goes: stage times on the host
              clock, the device's busy share and its heaviest kernels
  7. train    make_train_step at full width on B=512: the eager warm-up,
              the capture and 5 counted replays; both kernels must run
              exactly 5 times per step, the LayerNorm kernels 27 and 17
              times (counted on the card under replay);
              ms per step, QA/s, the loss of each step, then one profiled
              step: device busy share and heaviest kernels; then two
              replays, each against the eager step from the same state and
              generators (rewound in place): the loss within phase 8's
              limit, the gradient and parameter differences printed beside
              those of a second eager run (the eager step's own backward
              differs from run to run: atomic sums)
  8. train-parity  one float32 train step of the full-width model on B=8,
              card against CPU: loss, every gradient, updated parameters
              and BatchNorm running statistics (a ReLU input whose sign
              differs from the CPU's at round-off takes the CPU's value)
  9. data     the port's synthetic generator writes a GQA-shaped set (4,096
              train and 1,024 val questions, 1,540 scenes) under
              build/chip_smoke/; the native packer must be the one in use;
              dataset prewarm time, collate rate at B=512 with 0 and 2
              workers (batches/s, ms per batch), the layout counts and the
              dense rungs the batches reached
 10. ladder   both kernels against their plain versions, bf16 and f32, at
              every rung phase 9 reached and at (256, 1024) and (512, 2048),
              at B=512 on those batches with one graph filling the rung;
              max error and device time per rung (the worst error goes into
              the kernels line as ladder_max_abs_err, apart from
              max_abs_err, which stays that of phases 2 and 3)
 11. cli      python -m graphvqa_tpu_torch.cli.train_cli at full width
              (B=512, --workers 2 --validate-every 1 --fast-validate 2):
              one epoch on phase 9's data with a checkpoint, then --resume
              --evaluate with the result and attention dumps, then the
              port's scorer over them; steps/s, epoch wall, data-wait, eval
              QA/s, the scorer's accuracy, and the kernel launches the CLI
              counted (GAT 5 forward per eval step, 5 + 5 per train step;
              LayerNorm 357 per eval step, 27 + 17 per train step); then
              one batch forced into the flat layout through the eval step,
              card against CPU, and a train step on the card
 12. families the other model families at full width: gcn_config(),
              gine_config(), lcgn_config(), onlysg_config() and gat_config()
              with the execution engine (and its bitmap loss). Each: card
              against CPU on B=8 in bf16 (logits, and the bitmap, as phase
              4 holds them) and in one f32 train step (phase 8's limits);
              make_eval_step and make_train_step at B=512 as phases 5 and 7
              run them, 3 counted calls each, with the same replays held
              against the eager step (phase 12's limits for eval; LCGN's
              context generator rewound with the state) (ms per step, QA/s,
              each step's loss, peak memory, one profiled step's busy share
              and heaviest five kernels); the GAT kernels must run 5 (eval) and
              5 + 5 (train) times per step on onlysg and exec, never on gcn,
              gine and lcgn, and the LayerNorm kernels as step_launches
              counts them by the code (27 + 27 a train step on the
              baselines, whose program loss reaches the program decoder;
              onlysg runs no question encoder). LCGN's context features come from a seeded
              generator on the card, and from one fixed draw on both sides
              where card and CPU are compared. Then one CLI epoch of
              --model lcgn --use-execution-engine (2 steps of B=512 on
              phase 9's val split, a 1-batch validation with the bitmap
              meters)
 13. multi    the multi-device paths, ranks spawned on the one card over
              gloo: (a) both kernels against their plain versions on one
              edge rank's share of phase 2's batch at K=2 and K=4, i.e. at
              (npg, epg_loc) = (64, 128) and (64, 64), f32 and bf16, with the
              graph shift given as the edge group's max; error, cold-L2
              device time and bound. (b) the data-parallel step,
              gat_config() at full width, two ranks of B=256: one f32 step
              whose per-rank gradients equal the single-process step on each
              rank's batch and whose parameters equal the average-then-Adam,
              then three f32 steps captured (graph A, gloo's one all-reduce
              on the host, graph B) against eager, bitwise under
              deterministic algorithms, then bf16 steps eager and captured
              side by side (ms per step per rank, host launch calls, one
              all-reduce per step, capture seconds, peak memory, GAT
              launches 5 + 5 and LayerNorm 27 + 17 per rank per step
              counted on the card); then
              the same step on a one-rank NCCL group given as the mesh's
              world group, its all-reduce captured inside the one graph,
              bitwise against eager. (c) the edge-sharded step, B=512 at
              data 1 x edge 2: one f32 step against the single-process step
              (phase 8's limits, with the ReLU pins); three f32 steps
              captured (19 graphs a step, cut at each of gloo's collectives
              in the forward and backward and at the step's all-reduce)
              against eager, and an edge eval request (12 graphs) captured
              against eager, bitwise on both ranks under deterministic
              algorithms; bf16 steps and requests eager and captured side
              by side (ms, host launch calls, the collectives per call held
              to the eager step's in number and order, segments, capture
              seconds, peak memory, GAT launches counted on the card, the
              epg_loc reached); one step at data 2 x edge 2 on 4 ranks,
              eager, then captured after its warm-up; then the edge step
              and request on a one-rank NCCL group given as the mesh's
              world and edge group, each one graph holding every
              collective, bitwise against eager in f32 and timed in bf16.
              (d) the CLI under torchrun: one rank on nccl (an epoch,
              validation, --resume --evaluate with the dumps),
              --data-parallel 2 and --edge-parallel 2 on two ranks over
              gloo (two epochs each), whose gathered dumps hold every val
              question once and each of whose ranks captures and replays
              its train and eval steps. (e) convert_ckpt_cli on a
              reference-format checkpoint of the seeded full-width model,
              restored logits equal, --resume --evaluate on the card.
              Several ranks on one card measure the port's overheads, not
              scaling
 14. graphs   the steps as CUDA graphs at full width, B=512: per family
              (gat and phase 12's), three f32 train steps with dropout (and
              LCGN's context draws), captured (warm-up, capture, replay)
              against eager from the same weights and generator seeds under
              deterministic algorithms (losses, parameters, gradients and
              running statistics bitwise, or else phase 8's limits, with
              the largest difference printed); the main rung and the
              smallest bumped rung of phase 9's data interleaved in bf16
              (main, main, bumped, bumped, main, bumped, main: a train step
              and an eval request each), captured against eager from one
              rewound state under deterministic algorithms, bitwise; then
              the graphs the port runs: ms per step captured and eager for
              bf16 eval and train, each one's profiled device busy time,
              kernels and host launch calls; GAT and LayerNorm launches per
              step counted on the card under replay (5 and 357 eval, 5 + 5
              and 27 + 17 train); the bumped
              rung captures a second train and eval graph, after which the
              main rung replays without a capture, each replay held against
              the eager step between the bumped rung's replays (as phases 5
              and 7 hold them); capture seconds per rung and peak memory
              with the graphs cached
 15. layer-norm  the Transformer stacks' LayerNorm kernels against the plain
              composite at the rows they take at B=200 (6,400, 1,000,
              16,000 and 200 x 512), x in bf16 and f32, y bf16: the
              forward's statistics against float64 and its output against
              the composite within tests/torch_port_fixtures.py's
              LAYER_NORM_ULPS, bit for bit the composite's formula at its
              own statistics; the backward against autograd through the
              composite, and twice bit for bit; then each kernel's device
              time (cold L2) beside its least-bytes bound, the composite's
              time and F.layer_norm's. Every phase above that runs a model
              holds its LayerNorm launches, counted on the card, to
              step_launches
 16. gine     the GINE round's kernel pair (ops/gine_messages.py) at the
              gine cell's shape (B=200, npg=64, epg=256, C=300, D=512) on
              GQA-shaped random graphs, in bf16, in the bf16 model's first
              round's dtypes (h float32) and in float32: forward and
              backward against the plain versions on the card (the ins
              half and d_edge_attr bit for bit), two runs bit for bit, one
              launch each counted on the card; then each kernel's device
              time (cold L2) beside its least-bytes bound, the plain
              versions' and the composite's (CUDA events). Every phase
              above that runs a model holds the pair's launches to
              step_launches: 5 a gine eval request, 5 + 5 a gine train
              step, 0 on every other family
 17. lcgn     LCGN's node-wise float32 linear pair (ops/lcgn_linear.py) at
              the lcgn cell's shapes (B=200 at npg 64 and 128; 300, 512,
              1,024 and 1,536 -> 512 and the stacked 1,536 -> 1,536) on
              masks drawn from the traffic's scene law: the row list
              against its plain twin; forward, dx, dW and db against the
              plain versions on the card within the float32 round-off
              bound, padding rows 0, two runs bit for bit, one launch each
              counted on the card; each kernel's device time (cold L2)
              beside its bound (real-row FLOPs at 67 TFLOP/s or bytes at
              3.35 TB/s, the larger), the plain versions' time and
              F.linear's over every padded row (library_ms), the share of
              rows computed and the sums over one train step's 15 linears.
              Every phase above that runs a model holds the row list's and
              the pair's launches to step_launches: 1 and 15 an lcgn eval
              request, 1, 15 and 15 an lcgn train step, 0 on every other
              family

Each phase's seconds print as "[seconds] phase N".

The last two lines are the card's name and power limit (nvidia-smi) and a
{"kernels": [...]} summary before the final {"ok": true, "device": ...}.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores (the kernel's FMAs run on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

B, NPG, EPG, H, C = 512, 64, 256, 4, 300
# (atol, rtol) of the kernel against the plain version's float32 result. f32:
# the same sums in another order. bf16: the kernel accumulates in f32 and
# rounds once, so only that rounding (half an ulp, 2^-8 relative) is allowed
# on top of the f32 reordering.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2.0 ** -8)}
# Card against CPU, full width in bf16 on both sides: logits within 0.02
# (the first runs read 0.0039 on logits of |x| <= 0.68), and every argmax
# equal unless the CPU's top two logits lie within that limit.
PARITY_ATOL = 0.02
# Phase 12 holds the other families to the same limit scaled by the CPU's
# largest |logit| where that exceeds 1: bf16 rounds relative to the value,
# and GINE's sum aggregation gives logits up to ~4, where 0.02 is under
# two bf16 ulps (first run: gine 0.0312 at |logit| 4.03, 0.8 %, against
# gat's 0.0039 at 0.68 and gcn's 0.0039 at 0.75, 0.5-0.6 %).
# The backward's float32 outputs (d_alpha_l/r/e) against the plain version:
# the same f32 sums in another order.
BWD_F32_TOL = (1e-4, 1e-4)
# One float32 train step, card against CPU (TF32 off): the loss to rtol
# 1e-5; each gradient within 1e-3 of its tensor's largest |gradient| plus
# 1e-7 (the same sums in another order through some 30 layers); updated
# parameters to 1e-6 where the CPU's |gradient| > 1e-5 (far above Adam's
# eps, where the first step is well conditioned); running statistics to
# rtol/atol 1e-4.
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_PARAM_ATOL = 1e-5, 1e-3, 1e-6
# A ReLU whose input lies within f32 round-off of 0 can fall either way on
# the two devices, and then its unit's gradient moves by its whole share
# (PR 6's first readings: in lcgn at |x| = 1.8e-7 and 8.5e-7 in the program
# decoder's FFNs, in gine at 2.8e-8 in the pooling's node_nn; 5.1e-2 and
# 2.5e-3 of those tensors' largest gradient). So the card's run sets each
# ReLU input whose sign differs from the CPU's to the CPU's value, and the
# limits above hold element by element; such an input may differ from the
# CPU's by at most PIN_TOL of its tensor's largest |x| (the f32 forward's
# limit in TOL), else the step fails.
PIN_TOL = 1e-4
DROPOUT = 0.1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def gqa_samples(num_graphs, seed, avg_nodes=17, avg_edges=90):
    """GQA-shaped random scene graphs, drawn as bench.py:make_batch draws
    them (~17 nodes, ~90 edges plus one per node)."""
    import numpy as np
    from graphvqa_tpu_torch.core.packing import GraphSample
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(num_graphs):
        n = max(2, int(rng.normal(avg_nodes, 6)))
        e = n + max(n, int(rng.normal(avg_edges, 25)))
        samples.append(GraphSample(
            node_tokens=rng.integers(2, 2000, size=(n, 12)).astype(np.int32),
            edge_src=rng.integers(0, n, size=e).astype(np.int32),
            edge_dst=rng.integers(0, n, size=e).astype(np.int32),
            edge_tokens=rng.integers(2, 2000, size=(e, 1)).astype(np.int32),
            edge_sym=rng.random(e) > 0.7))
    return samples


def qa_batch(cfg, num_graphs, seed, graphs=None):
    """A synthetic request: GQA-shaped graphs (or ``graphs``) and random
    token streams with config.BatchConfig's lengths (question 32, program
    16, answer 20)."""
    import numpy as np
    import torch
    from graphvqa_tpu_torch.core.graph import QABatch
    from graphvqa_tpu_torch.core.packing import pack_graphs_dense
    bc, mc = cfg.batch, cfg.model
    if graphs is None:
        graphs = pack_graphs_dense(gqa_samples(num_graphs, seed), NPG, EPG,
                                   max_steps=mc.max_execution_steps)
    rng = np.random.default_rng(seed + 1)
    V = mc.text.vocab_size

    def tokens(rows, length):
        t = rng.integers(4, V, size=(rows, length)).astype(np.int32)
        t[:, 0] = mc.text.sos_idx
        return torch.from_numpy(t)

    return QABatch(
        graphs=graphs, questions=tokens(num_graphs, bc.question_len),
        programs=tokens(num_graphs * mc.max_execution_steps, bc.program_len),
        full_answers=tokens(num_graphs, bc.full_answer_len),
        short_answer_label=torch.from_numpy(rng.integers(
            0, mc.num_answers, size=num_graphs).astype(np.int32)))


def cuda_median_ms(fn, reps=20, inner=10, warmup=3):
    """Median over ``reps`` of (CUDA-event time of ``inner`` back-to-back
    calls) / ``inner``, after ``warmup`` calls. Host work inside ``fn``
    counts too, so this is the caller's time, not the kernel's."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_median_ms(fn, kernel_name, flush, reps=20, tries=3):
    """Median device duration of the ``kernel_name`` kernels that ``reps``
    calls of ``fn`` launch, from torch.profiler's CUDA events. ``flush`` (a
    tensor larger than the 50 MB L2) is zeroed before each call, so every
    call starts from a cold L2; the flush kernels are not counted. A window
    in which the profiler recorded none of them (it happens now and then)
    is profiled again, up to ``tries`` windows; None when none recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and kernel_name in ev.name]
        if us:
            return statistics.median(us) / 1e3
        log(f"[timing] profiler window {attempt + 1} recorded no "
            f"{kernel_name} events; profiling again")
    return None


def host_us_per_call(fn, calls=200):
    """Host-clock microseconds per call of ``fn``, without a synchronize
    inside the timed window: the wrapper's own work (checks, ctypes, the
    launch call), while the card runs behind it."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernel_inputs(dev):
    """Phase 2's batch: the main graph packed at the main widths and random
    scores and values from a seeded generator on the card."""
    import torch
    from graphvqa_tpu_torch.ops.dense import dense_local_indices
    graph = pack_main_graph().to(dev)
    dl, sl = dense_local_indices(graph)
    mask = graph.edge_mask.reshape(B, EPG).float()
    gen = torch.Generator(device=dev).manual_seed(0)
    N = B * NPG
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    return dict(dl=dl, sl=sl, mask=mask, al=randn(N, H), ar=randn(N, H),
                ae=randn(B, EPG, H), xw32=randn(N, H, C), ins32=randn(B, H, C),
                real_nodes=int(graph.node_mask.sum()))


def real_counts(inp):
    """(distinct real sources, distinct real destinations, real edges) of
    kernel_inputs' batch."""
    import torch
    dl, sl, mask = inp["dl"].long(), inp["sl"].long(), inp["mask"]
    real = (mask > 0) & (dl >= 0) & (dl < NPG) & (sl >= 0) & (sl < NPG)
    base = torch.arange(B, device=dl.device)[:, None] * NPG
    return (int(torch.unique((sl + base)[real]).numel()),
            int(torch.unique((dl + base)[real]).numel()), int(real.sum()))


def least_bytes(inp, elem, with_ins, epg=EPG):
    """The fewest bytes one GAT round must move on this batch, as the
    benchmark counts them (``benchmark/counts/gat_bytes.py``): each input
    element that the result depends on read once, the output written once.
    Padded node rows of xw are never read, so they do not count."""
    from benchmark.counts.gat_bytes import forward_bytes
    return forward_bytes(B, NPG, epg, H, C, elem, *real_counts(inp),
                         with_ins=with_ins)


def phase_kernel(dev):
    import torch
    from graphvqa_tpu_torch.ops.gat_round import (
        gat_round, gat_round_reference)
    inp = kernel_inputs(dev)
    dl, sl, mask, al, ar, ae = (inp[k] for k in ("dl", "sl", "mask", "al",
                                                  "ar", "ae"))
    xw32, ins32 = inp["xw32"], inp["ins32"]
    real_edges = int(mask.sum())
    real_nodes = inp["real_nodes"]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        xw = xw32.to(dtype)
        for shift in ("graph", "dst"):
            for ins in (None, ins32.to(dtype)):
                args = (dl, sl, mask, al, ar, ae, xw, ins)
                kw = dict(npg=NPG, epg=EPG, shift=shift)
                got = gat_round(*args, **kw)
                # the plain version on the same values in f32: its result
                # before the cast to the output's dtype
                want = gat_round_reference(
                    dl, sl, mask, al, ar, ae, xw.float(),
                    None if ins is None else ins.float(), **kw)
                torch.cuda.synchronize()
                diff = (got.float() - want).abs()
                atol, rtol = TOL[name]
                bad = diff > atol + rtol * want.abs()
                err = float(diff.max())
                if not torch.isfinite(got).all() or bool(bad.any()):
                    fail(f"gat_round {name} shift={shift} ins={ins is not None}"
                         f": max abs err {err:.3e} beyond atol {atol} rtol "
                         f"{rtol} at {int(bad.sum())} entries")
                call = lambda: gat_round(*args, **kw)  # noqa: E731
                k_ms = device_median_ms(call, "gat_round_kernel", flush)
                if k_ms is None:
                    fail("torch.profiler recorded no gat_round_kernel time")
                ev_ms = cuda_median_ms(call)
                host_us = host_us_per_call(call)
                p_ms = cuda_median_ms(lambda: gat_round_reference(*args, **kw),
                                      reps=10, inner=2, warmup=1)
                nbytes = least_bytes(inp, dtype.itemsize, ins is not None)
                flops = (2 * H * C + 12 * H) * real_edges + (
                    0 if ins is None else 2 * H * C * real_nodes)
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_F32_FLOPS * 1e3
                bound = max(t_bytes, t_ops)
                key = (name, shift, ins is not None)
                results[key] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, flops=flops)
                log(f"[kernel] {name:8s} shift={shift:5s} ins={ins is not None!s:5s}"
                    f" max_abs_err={err:.3e} (atol {atol}, rtol {rtol})"
                    f" device={k_ms * 1e3:.2f}us cold-L2"
                    f" ({100 * bound / k_ms:.1f}% of bound);"
                    f" events around calls"
                    f" {ev_ms * 1e3:.2f}us; wrapper host {host_us:.2f}us/call;"
                    f" plain={p_ms * 1e3:.1f}us bound={bound * 1e3:.2f}us"
                    f" ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    log(f"[kernel] real edges {real_edges}, real nodes {real_nodes} "
        f"of {B * EPG} / {B * NPG} slots")
    keep = keep_scale(inp, seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        xw, ins = xw32.to(dtype), ins32.to(dtype)
        out, alpha = gat_round(dl, sl, mask, al, ar, ae, xw, ins, npg=NPG,
                               epg=EPG, keep_scale=keep, return_alpha=True)
        want, want_alpha = gat_round_reference(
            dl, sl, mask, al, ar, ae, xw.float(), ins.float(), npg=NPG,
            epg=EPG, keep_scale=keep, return_alpha=True)
        torch.cuda.synchronize()
        atol, rtol = TOL[name]
        errs = []
        for got, ref in ((out, want), (alpha, want_alpha)):
            diff = (got.float() - ref).abs()
            errs.append(float(diff.max()))
            if (not torch.isfinite(got).all()
                    or bool((diff > atol + rtol * ref.abs()).any())):
                fail(f"gat_round {name} with dropout scale and attention: "
                     f"max abs err {errs[-1]:.3e}")
        log(f"[kernel] {name:8s} dropout scale + attention output: max abs "
            f"err out {errs[0]:.3e}, attention {errs[1]:.3e}")
        results[(name, "train")] = dict(max_abs_err=max(errs))
    return results


def keep_scale(inp, seed):
    """An attention dropout scale [B, EPG, H] at the model's rate."""
    import torch
    gen = torch.Generator(device=inp["dl"].device).manual_seed(seed)
    keep = torch.rand(B, EPG, H, generator=gen, device=inp["dl"].device)
    return (keep >= DROPOUT).float() / (1.0 - DROPOUT)


def backward_least_bytes(inp, elem, with_keep, epg=EPG):
    """The fewest bytes one GAT-round backward must move on this batch, as
    the benchmark counts them (``benchmark/counts/gat_bytes.py``: the
    forward's inputs that the gradients depend on read once, every gradient
    written once in full) -> (bytes, real edges, real destinations)."""
    from benchmark.counts.gat_bytes import backward_bytes
    n_src, n_dst, n_edges = real_counts(inp)
    return (backward_bytes(B, NPG, epg, H, C, elem, n_src, n_dst, n_edges,
                           with_keep=with_keep), n_edges, n_dst)


def phase_backward(dev):
    import torch
    from graphvqa_tpu_torch.ops.gat_round import (
        _backward_launch, gat_round_backward, gat_round_backward_reference)
    inp = kernel_inputs(dev)
    args = tuple(inp[k] for k in ("dl", "sl", "mask", "al", "ar", "ae"))
    keep = keep_scale(inp, seed=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    grad32 = torch.randn(B * NPG, C, generator=gen, device=dev)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    names = ("d_xw", "d_alpha_l", "d_alpha_r", "d_alpha_e", "d_ins")
    results = {}
    cases = [("bfloat16", "graph", True), ("bfloat16", "graph", False),
             ("bfloat16", "dst", True), ("float32", "graph", True),
             ("float32", "dst", False)]
    for name, shift, with_keep in cases:
        dtype = getattr(torch, name)
        xw, ins, grad = (inp["xw32"].to(dtype), inp["ins32"].to(dtype),
                         grad32.to(dtype))
        k = keep if with_keep else None
        call_args = (grad,) + args + (xw, ins, k)
        kw = dict(npg=NPG, epg=EPG, shift=shift)
        got = gat_round_backward(*call_args, **kw)
        want = gat_round_backward_reference(
            grad.float(), *args, xw.float(), ins.float(), k, **kw)
        torch.cuda.synchronize()
        err = 0.0
        for out_name, g, w in zip(names, got, want):
            atol, rtol = (TOL[name] if out_name in ("d_xw", "d_ins")
                          else BWD_F32_TOL)
            diff = (g.float() - w.float()).abs()
            err = max(err, float(diff.max()))
            if (not torch.isfinite(g).all()
                    or bool((diff > atol + rtol * w.float().abs()).any())):
                fail(f"gat_round_backward {name} shift={shift} keep="
                     f"{with_keep}: {out_name} max abs err "
                     f"{float(diff.max()):.3e} beyond atol {atol} rtol {rtol}")
        again, counter = _backward_launch(*call_args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"gat_round_backward {name} shift={shift}: two runs differ")
        units = int(counter)
        if units != B * H:
            fail(f"gat_round_backward handed out {units} work units, "
                 f"expected B*H = {B * H}")
        call = lambda: gat_round_backward(*call_args, **kw)  # noqa: E731
        k_ms = device_median_ms(call, "gat_round_backward_kernel", flush)
        if k_ms is None:
            fail("torch.profiler recorded no gat_round_backward_kernel time")
        host_us = host_us_per_call(call)
        p_ms = cuda_median_ms(
            lambda: gat_round_backward_reference(*call_args, **kw),
            reps=5, inner=2, warmup=1)
        nbytes, n_edges, n_dst = backward_least_bytes(inp, dtype.itemsize,
                                                      with_keep)
        flops = 4 * H * C * n_edges + 4 * H * C * n_dst + 24 * H * n_edges
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        results[(name, shift, with_keep)] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"[backward] {name:8s} shift={shift:5s} keep={with_keep!s:5s} "
            f"max_abs_err={err:.3e} deterministic device={k_ms * 1e3:.2f}us "
            f"cold-L2 ({100 * bound / k_ms:.1f}% of bound); wrapper host "
            f"{host_us:.2f}us/call; plain={p_ms * 1e3:.1f}us bound="
            f"{bound * 1e3:.2f}us ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} "
            f"GFLOP); work units per launch {units} ({B} graphs x {H} "
            f"heads, from the counter)")
    return results


def pack_main_graph():
    from graphvqa_tpu_torch.core.packing import pack_graphs_dense
    return pack_graphs_dense(gqa_samples(B, seed=0), NPG, EPG)


def randomize_bn_stats(model, seed):
    import torch
    from graphvqa_tpu_torch.nn.norm import MaskedBatchNorm
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                mean = torch.randn(m.running_mean.shape, generator=gen) * 0.5
                var = torch.rand(m.running_var.shape, generator=gen) * 1.5 + 0.5
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)


def full_model(cfg, device):
    from graphvqa_tpu_torch.models.pipeline import build_model
    model = build_model(cfg.model, device="cpu", seed=0)
    randomize_bn_stats(model, seed=1)
    return model.to(device)


def ctx_noise(cfg, batch):
    """One fixed draw of LCGN's context features for ``batch`` (CPU)."""
    import torch
    return torch.randn(batch.graphs.nodes_pad,
                       cfg.model.transformer.hidden_dim,
                       generator=torch.Generator().manual_seed(7))


def fixed_ctx(model, noise):
    """An lcgn model whose context features are ``noise`` at every
    forward, so that the card and the CPU start from the same draw (their
    generators differ); other models as they are."""
    if model.cfg.engine.kind == "lcgn":
        model.lcgn_seq.forward = functools.partial(
            model.lcgn_seq.forward,
            x_ctx=noise.to(next(model.parameters()).device))
    return model


def phase_parity(cfg, dev, model_gpu, tag="parity", relative=False):
    """The eval path on B=8, card against CPU: logits within PARITY_ATOL
    (times max(1, the CPU's largest |logit|) with ``relative``), argmaxes
    equal but for near ties, and the execution bitmap within the same."""
    import torch
    batch = qa_batch(cfg, 8, seed=11)
    noise = ctx_noise(cfg, batch)
    model_cpu = fixed_ctx(full_model(cfg, "cpu"), noise)
    model_gpu = fixed_ctx(model_gpu, noise)
    t0 = time.perf_counter()
    out_gpu = model_gpu.sample(batch.to(dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_cpu = model_cpu.sample(batch.to("cpu"))
    t2 = time.perf_counter()
    g = out_gpu.short_answer_logits.float().cpu()
    c = out_cpu.short_answer_logits.float()
    if g.shape != (8, cfg.model.num_answers) or not torch.isfinite(g).all():
        fail(f"{tag}: card logits: shape {tuple(g.shape)} or non-finite "
             f"values")
    bitmap_err = None
    if cfg.model.use_execution_engine:
        gb = out_gpu.execution_bitmap.float().cpu()
        cb = out_cpu.execution_bitmap.float()
        real = batch.graphs.node_mask
        if not torch.isfinite(gb).all():
            fail(f"{tag}: card bitmap not finite")
        bitmap_err = float((gb - cb)[real].abs().max())
    err = float((g - c).abs().max())
    limit = PARITY_ATOL * (max(1.0, float(c.abs().max())) if relative
                           else 1.0)
    same = g.argmax(-1) == c.argmax(-1)
    top2 = c.topk(2, dim=-1).values
    close = (top2[:, 0] - top2[:, 1]) <= limit          # a near tie on the CPU
    tok = float((out_gpu.program_tokens.cpu() == out_cpu.program_tokens)
                .float().mean())
    extra = ("" if bitmap_err is None else
             f", bitmap max |card - cpu| {bitmap_err:.4f} on real nodes")
    log(f"[{tag}] B=8 {cfg.model.dtype} full width: max |logit card - cpu| "
        f"= {err:.4f} (limit {limit:.4f}), |logit| max "
        f"{float(c.abs().max()):.3f}, argmax equal on {int(same.sum())}/8 "
        f"rows ({int((~same).sum())} differ, {int(close.sum())} near ties), "
        f"program tokens agree {tok:.3f}{extra}; card {t1 - t0:.2f}s cpu "
        f"{t2 - t1:.2f}s")
    if err > limit or bool((~same & ~close).any()):
        fail(f"{tag}: card and CPU disagree on the eval path")
    if bitmap_err is not None and bitmap_err > PARITY_ATOL:
        fail(f"{tag}: card and CPU bitmaps differ by {bitmap_err:.4f}")
    del model_cpu


def peak_gib(dev) -> str:
    """The peak of allocated memory since the last reset, and of the
    caching allocator's reserve (a graph's pool stays reserved)."""
    import torch
    return (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
            f"allocated, {torch.cuda.max_memory_reserved(dev) / 2**30:.2f} "
            f"GiB reserved")


def gat_rounds(cfg):
    """GAT-kernel launches per step (forward, or backward) of a config:
    one per round on the gat engines (gat, and onlysg's "none"), none on
    gcn, gine and lcgn."""
    e = cfg.model.engine
    return e.num_rounds if e.kind in ("gat", "none") else 0


def layer_norm_launches(cfg):
    """LayerNorm-kernel launches of a config, by the code: (forward a train
    step, backward a train step, forward an eval request). The question
    encoder's layers take 2 norms each and the decoders' 3, each stack one
    more at its end (7 and 10 at 3 layers); onlysg runs no question
    encoder. A train step runs the encoder, the coarse decoder and the
    teacher-forced program decoder forward; autograd runs back through the
    program decoder only where the program loss reaches it. An eval
    request runs the encoder and the coarse decoder, then one decoder stack
    per greedy step: program_decode_len - 1 steps and, with the full
    answer, full_answer_decode_len - 1 more."""
    m = cfg.model
    n = m.transformer.num_layers
    enc = 0 if m.engine.kind == "none" else 2 * n + 1
    dec = 3 * n + 1
    steps = m.program_decode_len - 1 + (
        m.full_answer_decode_len - 1 if m.use_full_answer else 0)
    return (enc + 2 * dec,
            enc + dec + (dec if cfg.train.use_program_loss else 0),
            enc + dec + steps * dec)


def gine_rounds(cfg):
    """GINE-kernel launches per step (forward, or backward) of a config:
    one per round on gine's dense batches, none on the other engines."""
    e = cfg.model.engine
    return e.num_rounds if e.kind == "gine" else 0


def lcgn_linears(cfg):
    """(row lists, linears) of one forward of a config: on lcgn one row list
    and init_sg_emb_input, proj_x_loc and fin_layer, then proj_x_ctx,
    lin_l/lin_r/cal_x (one launch) and output_layer per iteration, on any
    layout; none on the other engines. A train step's backward launches
    once per linear."""
    e = cfg.model.engine
    return (1, 3 + 3 * e.lcgn_iters) if e.kind == "lcgn" else (0, 0)


def kernel_launches(**counts):
    """{kind: launches} for every kind the kernels count, in
    ``ops/cuda_lib.py:KINDS``'s order; 0 where not given."""
    from graphvqa_tpu_torch.ops.cuda_lib import KINDS
    unknown = set(counts) - set(KINDS)
    if unknown:
        raise KeyError(f"no kernel counts {sorted(unknown)}")
    return {kind: counts.get(kind, 0) for kind in KINDS}


def scaled(launches, n):
    """``launches`` ({kind: launches}) times ``n``."""
    return {kind: v * n for kind, v in launches.items()}


def step_launches(cfg, train):
    """{kind: launches} of one train step (``train``) or eval request of a
    config on a dense batch."""
    rounds, gine = gat_rounds(cfg), gine_rounds(cfg)
    fwd, bwd, ev = layer_norm_launches(cfg)
    lists, linears = lcgn_linears(cfg)
    if train:
        return kernel_launches(
            gat_round=rounds, gat_round_backward=rounds, layer_norm=fwd,
            layer_norm_backward=bwd, gine_messages=gine,
            gine_messages_backward=gine, lcgn_rows=lists,
            lcgn_linear=linears, lcgn_linear_backward=linears)
    return kernel_launches(gat_round=rounds, layer_norm=ev,
                           gine_messages=gine, lcgn_rows=lists,
                           lcgn_linear=linears)


def launch_counts():
    """{kind: launches} since the last reset_launch_counts(), as the
    kernels counted them on the card (CUDA graph replays too)."""
    from graphvqa_tpu_torch.ops import cuda_lib
    return cuda_lib.launch_counts()


def launches_since(before):
    """{kind: launches} since ``before``, a launch_counts() reading."""
    return {kind: n - before[kind] for kind, n in launch_counts().items()}


def reset_launch_counts():
    from graphvqa_tpu_torch.ops import cuda_lib
    cuda_lib.reset_launch_counts()


def launch_text(launches):
    """'gat_round N, gat_round_backward N, ...', as the CLI prints them."""
    return ", ".join(f"{kind} {n}" for kind, n in launches.items())


def cli_launches(text, what):
    """{kind: launches} of the CLI's last 'kernel launches (``what``)'
    line."""
    line = _last_match(rf"kernel launches \({re.escape(what)}\): (.*)", text,
                       f"{what} launches")
    return {kind: int(n) for kind, n in re.findall(r"(\w+) (\d+)", line)}


def phase_serve(cfg, dev, model, tag="serve", ctx=None, relative=False):
    """make_eval_step, a CUDA graph replayed per request, on 3 counted
    B=512 requests after the eager warm-up and the capture (counts set to 0
    just before them and read just after), then two more replays held
    against the eager step (hold_eval_replays; ``relative`` as phase 12
    scales the limit); ``ctx`` is LCGN's generator."""
    import torch
    from graphvqa_tpu_torch.train.loop import make_eval_step
    step = make_eval_step(model, cfg)
    requests = [qa_batch(cfg, B, seed=100 + i).to(dev) for i in range(4)]
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):                  # the eager warm-up, then the capture
        step(requests[0], ctx)
    torch.cuda.synchronize()
    if (step.graphs.captures, step.graphs.replays) != (1, 1):
        fail(f"{tag}: the eval step captured {step.graphs.captures} graphs "
             f"and replayed {step.graphs.replays} in its first two requests")
    reset_launch_counts()
    times, outs = [], []
    for req in requests[1:]:
        t0 = time.perf_counter()
        out = step(req, ctx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = launch_counts()
    want = step_launches(cfg, train=False)
    if launches != scaled(want, len(times)):
        fail(f"{tag}: {launch_text(launches)} launches in {len(times)} "
             f"requests, expected {launch_text(want)} per request")
    V = cfg.model.text.vocab_size
    for vectors, tokens, attention in outs:
        if not (torch.isfinite(vectors["sa_score"]).all()
                and torch.isfinite(attention).all()):
            fail(f"{tag}: non-finite eval outputs")
        if tokens.shape != (B * cfg.model.max_execution_steps,
                            cfg.model.program_decode_len):
            fail(f"{tag}: program tokens shape {tuple(tokens.shape)}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= V:
            fail(f"{tag}: program tokens out of the vocabulary")
        if vectors["sa_pred"].shape != (B,) or attention.shape != (B * NPG,):
            fail(f"{tag}: eval vector shapes")
        bitmap = vectors.get("execution_bitmap")
        if cfg.model.use_execution_engine and (
                bitmap is None or bitmap.shape != (
                    B * NPG, cfg.model.max_execution_steps)
                or not torch.isfinite(bitmap).all()):
            fail(f"{tag}: execution bitmap missing, misshapen or not finite")
    ms = [t * 1e3 for t in times]
    log(f"[{tag}] {len(times)} replayed requests of B={B}: ms/step "
        f"{', '.join(f'{m:.2f}' for m in ms)} (mean {statistics.mean(ms):.2f}),"
        f" QA/s {B / statistics.mean(times):.1f}, launches "
        f"{launch_text(launches)}, capture "
        f"{sum(step.graphs.capture_seconds.values()):.2f}s"
        f", peak memory {peak_gib(dev)}")
    held = hold_eval_replays(cfg, model, step, requests[1:3], ctx, tag,
                             relative)
    log(f"[{tag}] replays against the eager step: {held}")
    return launches, step, requests[-1]


def phase_profile(model, step, request):
    """Where one request's time goes, after the counted run: host-clock
    stage times (each stage ends in a synchronize), then one step under
    torch.profiler for the device's busy share and its heaviest kernels."""
    import torch
    emb, g = model.text_vocab_embedding, request.graphs

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        (x, e), t_sg = timed(lambda: model.scene_graph_encoder(g))
        mem, t_q = timed(lambda: model.question_encoder(request.questions,
                                                        emb))
        (_, instr), t_prog = timed(lambda: model.program_decoder.sample(
            mem, emb))
        h, t_gat = timed(lambda: model.gat_seq(g, x, e, instr))

        def head():
            feat, _ = model.graph_global_attention_pooling(g, h, mem[:, 0])
            q = mem[:, 0]
            return model.logit_fc(torch.cat([feat, q, feat * q], dim=-1))

        _, t_head = timed(head)
        _, t_fa = timed(lambda: model.full_answer_decoder.sample(mem, emb))
    log(f"[profile] stage ms: scene-graph encoder {t_sg:.2f}, question "
        f"encoder {t_q:.2f}, program decoder {t_prog:.2f}, GAT engine "
        f"{t_gat:.2f}, pooling + classifier {t_head:.2f}, full-answer "
        f"decoder {t_fa:.2f}")

    profiled_step(lambda: step(request), "profile", 10)


def profiled_step(fn, tag, top):
    """One call of ``fn`` under torch.profiler: wall time, the device's
    busy share, the host's launch calls (the benchmark's
    ``HOST_LAUNCH_CALLS``) and its ``top`` heaviest kernels ->
    dict(wall_ms, busy_ms, kernels, host_launches), None when the profiler
    saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from benchmark.harness.trace import HOST_LAUNCH_CALLS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    launches = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in HOST_LAUNCH_CALLS:
            launches[ev.name] = launches.get(ev.name, 0) + 1
    if not kernels:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return None
    busy_us = sum(ev.time_range.elapsed_us() for ev in kernels)
    by_name = {}
    for ev in kernels:
        n, t = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, t + ev.time_range.elapsed_us())
    log(f"[{tag}] one profiled step: wall {wall_us / 1e3:.2f} ms, "
        f"{len(kernels)} device kernels, device busy {busy_us / 1e3:.2f} ms "
        f"= {100 * busy_us / wall_us:.1f}% of wall; host launch calls "
        f"{sum(launches.values())} {launches}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[{tag}]   {t / 1e3:8.3f} ms {n:6d}x  {name[:90]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                kernels=len(kernels), host_launches=sum(launches.values()))


def phase_train(cfg, dev, model, steps=5, tag="train", ctx=None, top=12):
    """The full-width train step on B=512, a CUDA graph replayed per step:
    the eager warm-up, the capture and ``steps`` counted steps (counts set
    to 0 just before them and read just after), one profiled step, then
    two replays on other batches held against the eager step
    (hold_train_replays). ``ctx`` is LCGN's generator."""
    import torch
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    tc = cfg.train
    state = create_train_state(model, lr=tc.lr, lr_drop=tc.lr_drop,
                               lr_gamma=tc.lr_gamma,
                               weight_decay=tc.weight_decay)
    step = make_train_step(model, cfg)
    batch = qa_batch(cfg, B, seed=200).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step(state, batch, gen, ctx)                        # warm-up step
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    step(state, batch, gen, ctx)                        # the capture
    torch.cuda.synchronize()
    if (step.graphs.captures, step.graphs.replays) != (1, 1):
        fail(f"{tag}: the train step captured {step.graphs.captures} graphs "
             f"and replayed {step.graphs.replays} in its first two steps")
    reset_launch_counts()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["total"]))
    launches = launch_counts()
    want = step_launches(cfg, train=True)
    if launches != scaled(want, len(times)):
        fail(f"{tag}: {launch_text(launches)} launches in {len(times)} "
             f"steps, expected {launch_text(want)} per step")
    if not all(map(math.isfinite, losses)):
        fail(f"{tag}: non-finite training loss: {losses}")
    parts = ", ".join(f"{k} {float(v):.5f}" for k, v in m.items()
                      if k in ("short_answer", "program", "execution_bitmap"))
    ms = [t * 1e3 for t in times]
    log(f"[{tag}] {len(times)} steps of B={B} at full width (dropout "
        f"{cfg.model.transformer.dropout}/{cfg.model.engine.dropout}/"
        f"{cfg.model.classifier_dropout}, lr {tc.lr}): ms/step "
        f"{', '.join(f'{v:.2f}' for v in ms)} (mean {statistics.mean(ms):.2f}"
        f", warm-up {warm * 1e3:.0f}, capture "
        f"{sum(step.graphs.capture_seconds.values()) * 1e3:.0f}), QA/s "
        f"{B / statistics.mean(times):.1f}"
        f"; loss per step {', '.join(f'{v:.5f}' for v in losses)} (last: "
        f"{parts}); launches per step {launch_text(want)}; peak memory "
        f"{peak_gib(dev)}")
    profiled_step(lambda: step(state, batch, gen, ctx), tag, top)
    held = hold_train_replays(
        cfg, state, step, [qa_batch(cfg, B, seed=201 + i).to(dev)
                           for i in range(2)], gen, ctx, tag)
    log(f"[{tag}] replays against the eager step: {held}")
    return launches


def relu_inputs(model):
    """(name, module) of the modules whose output a ReLU takes: the first
    layer of every Seq(Lin, ReLU, Lin), the transformers' ``linear1``,
    LCGN's ``qInput1`` and the BatchNorms between engine rounds. (GINE's
    message ReLU follows no module and is not among them.)"""
    import torch
    from graphvqa_tpu_torch.nn.norm import MaskedBatchNorm
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential) and any(
                isinstance(m, torch.nn.ReLU) for m in mod):
            yield f"{name}.0", mod[0]
        elif name.endswith(("linear1", "qInput1")) or isinstance(
                mod, MaskedBatchNorm):
            yield name, mod


def watch_relu_inputs(model, ref=None, tag="", edge_rows=None):
    """Forward hooks on relu_inputs(model). Without ``ref``: record every
    call's output on the CPU, {name: [output per call]}. With ``ref`` (such
    a record of the same step on the CPU): where an output's sign differs
    from ref's, its value becomes ref's (its gradient passes as before), so
    every ReLU goes the same way on both devices; an element so set may
    differ from ref's by at most PIN_TOL of ref's largest |x|. ``edge_rows``
    (an edge rank's slots as indices of ref's edges, -1 on padding) maps an
    output over the rank's share of the edges onto ref's rows. Returns
    (record, pins), pins a list of (name, call, elements, largest |x|)."""
    import torch
    record, pins = {}, []

    def hook(mod, args, out, name):
        calls = record.setdefault(name, [])
        if ref is None:
            calls.append(out.detach().cpu())
            return None
        calls.append(None)
        want = ref[name][len(calls) - 1].to(out.device)
        real = None
        if edge_rows is not None and want.shape[0] != out.shape[0]:
            real = (edge_rows >= 0).reshape(-1, *([1] * (out.ndim - 1)))
            want = want.index_select(0, edge_rows.clamp(min=0))
        flips = (out > 0) != (want > 0)
        if real is not None:
            flips = flips & real
        if not bool(flips.any()):
            return None
        gap = float((out.detach() - want)[flips].abs().max())
        if gap > PIN_TOL * float(want.abs().max()):
            fail(f"{tag}: ReLU input {name} (call {len(calls) - 1}) differs "
                 f"from the CPU's in sign by {gap:.3e}, beyond {PIN_TOL} of "
                 f"its largest |x|")
        pins.append((name, len(calls) - 1, int(flips.sum()),
                     float(want[flips].abs().max())))
        return out + torch.where(flips, want - out.detach(), 0.0)

    for name, mod in relu_inputs(model):
        mod.register_forward_hook(functools.partial(hook, name=name))
    return record, pins


def phase_train_parity(dev, base=None, tag="train-parity"):
    """One float32 train step of the full-width model (dropout 0) on B=8,
    card against CPU, from the same weights (gat_config() unless ``base``
    is given; LCGN's context features one fixed draw on both sides, and
    the ReLU inputs whose sign differs at round-off set to the CPU's, as
    watch_relu_inputs does): loss, every gradient, the updated parameters
    where |gradient| > 1e-5, and the running statistics."""
    import dataclasses
    import torch
    from graphvqa_tpu_torch.config import gat_config
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    base = base or gat_config()
    mc = base.model
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        mc, dtype="float32", classifier_dropout=0.0,
        transformer=dataclasses.replace(mc.transformer, dropout=0.0),
        engine=dataclasses.replace(mc.engine, dropout=0.0)))
    batch = qa_batch(cfg, 8, seed=21)
    noise = ctx_noise(cfg, batch)
    runs, ref = {}, None
    for device in ("cpu", dev):
        model = fixed_ctx(full_model(cfg, device), noise)
        ref, pins = watch_relu_inputs(model, ref, tag)
        state = create_train_state(model, lr=cfg.train.lr)
        t0 = time.perf_counter()
        _, m = make_train_step(model, cfg)(
            state, batch.to(device),
            torch.Generator(device=device).manual_seed(0))
        loss = float(m["total"])
        runs[str(device)] = dict(
            loss=loss, seconds=time.perf_counter() - t0,
            grads={n: (p.grad if p.grad is not None
                       else torch.zeros_like(p)).cpu()
                   for n, p in model.named_parameters()},
            params={n: p.detach().cpu() for n, p in model.named_parameters()},
            stats={n: b.cpu() for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))})
        del model, state
    del ref
    cpu, gpu = runs["cpu"], runs[str(dev)]
    pinned = "; ".join(f"{n} call {c}: {k} at |x| <= {x:.2e}"
                       for n, c, k, x in pins) or "none"
    log(f"[{tag}] f32 B=8 full width, one step: "
        f"{hold_train_step(cpu, gpu, tag, 'card', 'cpu')}; ReLU inputs set "
        f"to the CPU's sign: {pinned}; card {gpu['seconds']:.2f}s cpu "
        f"{cpu['seconds']:.2f}s")


def hold_train_step(ref, got, tag, got_name, ref_name, cond_grads=None):
    """Phase 8's limits on one float32 train step ``got`` against ``ref``
    (dicts of loss, grads, params and stats on the CPU): the loss to
    TRAIN_LOSS_RTOL; each gradient within TRAIN_GRAD_TOL of its tensor's
    largest |gradient| plus 1e-7; the updated parameters to
    TRAIN_PARAM_ATOL where |gradient| > 1e-5 (``cond_grads``, else ref's);
    the running statistics to rtol/atol 1e-4. Fails beyond them; returns
    the worst differences as text."""
    import torch
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_err = near_zero_err = param_err = stat_err = 0.0
    n_compared = 0
    for n, gc in ref["grads"].items():
        d = got["grads"][n] - gc
        scale = float(gc.abs().max())
        err = float(d.abs().max())
        if scale > 1e-5:
            grad_err = max(grad_err, err / scale)
        else:       # a gradient that is 0 in exact arithmetic: round-off
            near_zero_err = max(near_zero_err, err)
        if err > TRAIN_GRAD_TOL * scale + 1e-7:
            fail(f"{tag}: train step {got_name} vs {ref_name}: gradient of "
                 f"{n} differs by {err:.3e} (scale {scale:.3e})")
        # updates are compared where the gradients are well conditioned
        conditioned = (gc if cond_grads is None else cond_grads[n]).abs() \
            > 1e-5
        n_compared += int(conditioned.sum())
        perr = float((got["params"][n] - ref["params"][n])[conditioned]
                     .abs().max()) if bool(conditioned.any()) else 0.0
        param_err = max(param_err, perr)
        if perr > TRAIN_PARAM_ATOL:
            fail(f"{tag}: train step {got_name} vs {ref_name}: updated {n} "
                 f"differs by {perr:.3e}")
    for n, sc in ref["stats"].items():
        err = float((got["stats"][n] - sc).abs().max())
        stat_err = max(stat_err, err)
        if not torch.allclose(got["stats"][n], sc, rtol=1e-4, atol=1e-4):
            fail(f"{tag}: train step {got_name} vs {ref_name}: running "
                 f"statistic {n} differs by {err:.3e}")
    if not math.isfinite(got["loss"]) or loss_err > TRAIN_LOSS_RTOL:
        fail(f"{tag}: train step {got_name} vs {ref_name}: loss "
             f"{got['loss']} vs {ref['loss']}")
    return (f"loss {got_name} {got['loss']:.7f} {ref_name} "
            f"{ref['loss']:.7f} (rel {loss_err:.2e}, limit "
            f"{TRAIN_LOSS_RTOL}); worst gradient diff {grad_err:.2e} of its "
            f"tensor's scale where that exceeds 1e-5 (limit "
            f"{TRAIN_GRAD_TOL}), {near_zero_err:.2e} absolute in the others "
            f"(limit 1e-7 beyond the relative one); updated params "
            f"{param_err:.2e} where |grad| > 1e-5 ({n_compared} elements; "
            f"limit {TRAIN_PARAM_ATOL}); running stats {stat_err:.2e}")


SMOKE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
# the ladder's top rungs, which GQA-shaped data rarely or never reaches
FORCED_RUNGS = ((256, 1024), (512, 2048))


def _rung(graphs):
    return graphs.nodes_per_graph, graphs.edges_per_graph


def phase_data(cfg):
    """Phase 9: synthetic GQA-shaped data, the dataset's prewarm, the
    collate's rate at B=512 in-process and with two workers."""
    import dataclasses
    from graphvqa_tpu_torch.core.native import packer_name
    from graphvqa_tpu_torch.data import (
        GQADataset, build_scene_graph_vocab, build_text_vocab, tokenize)
    from graphvqa_tpu_torch.data.synthetic import (
        write_scorer_questions, write_synthetic_gqa)
    t_phase = time.perf_counter()
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    data = SMOKE_DIR / "data"
    t0 = time.perf_counter()
    write_synthetic_gqa(data, train_questions=4096, val_questions=1024,
                        scenes=1400, seed=0)
    write_scorer_questions(data, "val_balanced")
    t_gen = time.perf_counter() - t0
    packer = packer_name()
    if not packer.startswith("native"):
        fail(f"the collate's packer is {packer}, not the native one")
    programs = data / "questions" / "train_balanced_programs.json"
    text_vocab = build_text_vocab(json.loads(programs.read_text()), tokenize)
    ds = GQADataset(programs, data / "sceneGraphs" / "train_sceneGraphs.json",
                    text_vocab, build_scene_graph_vocab())
    t0 = time.perf_counter()
    ds.prewarm()
    t_prewarm = time.perf_counter() - t0
    bc = dataclasses.replace(cfg.batch, num_graphs=B)
    order = dict(shuffle=True, drop_last=True, size_bucket_windows=16)
    rates, layouts, rung_batches = {}, {}, {}
    for workers in (0, 2):
        for epoch in (0, 1):
            chunks = ds.batch_order(bc, seed=epoch, **order)
            t0 = time.perf_counter()
            n = 0
            for idx, (meta, batch) in zip(chunks, ds.iter_batches(
                    bc, seed=epoch, num_workers=workers, **order)):
                n += 1
                if workers == 0:
                    rung_batches.setdefault(_rung(batch.graphs), idx)
                    if epoch == 0:
                        layouts[meta["layout"]] = layouts.get(
                            meta["layout"], 0) + 1
            rates[(workers, epoch)] = (n, time.perf_counter() - t0)
    ds.close()
    for (workers, epoch), (n, sec) in sorted(rates.items()):
        log(f"[data] collate B={B} workers={workers} epoch {epoch}"
            f"{' (pool forked)' if workers and not epoch else ''}: {n} "
            f"batches in {sec:.3f}s = {n / sec:.2f} batches/s, "
            f"{1e3 * sec / n:.1f} ms per batch")
    log(f"[data] {len(ds)} train questions, {len(ds.sg_data)} scenes written "
        f"in {t_gen:.2f}s; prewarm {t_prewarm:.2f}s; packer {packer}; "
        f"layouts per epoch {layouts}; rungs reached "
        f"{sorted(rung_batches)}; phase {time.perf_counter() - t_phase:.1f}s")
    return dict(ds=ds, rung_batches=rung_batches, rates=rates,
                layouts=layouts, data=data)


def _filled(samples, npg, epg, seed):
    """``samples`` with the first replaced by a graph of npg nodes and epg
    edges, so the batch fills its rung."""
    import numpy as np
    from graphvqa_tpu_torch.core.packing import GraphSample
    rng = np.random.default_rng(seed)
    src = rng.integers(0, npg, size=epg).astype(np.int32)
    dst = rng.integers(0, npg, size=epg).astype(np.int32)
    src[0] = dst[1] = npg - 1
    full = GraphSample(
        node_tokens=rng.integers(2, 2000, size=(npg, 12)).astype(np.int32),
        edge_src=src, edge_dst=dst,
        edge_tokens=rng.integers(2, 2000, size=(epg, 1)).astype(np.int32),
        edge_sym=rng.random(epg) > 0.7)
    return [full] + list(samples[1:])


def phase_ladder(dev, data):
    """Phase 10: both kernels against their plain versions at every rung
    phase 9 reached and at the forced top rungs, all at the main path's
    B=512, so every block of the persistent grid takes several graphs."""
    import torch
    from graphvqa_tpu_torch.core.packing import pack_graphs_dense
    from graphvqa_tpu_torch.ops.dense import dense_local_indices
    from graphvqa_tpu_torch.ops.gat_round import (
        gat_round, gat_round_backward, gat_round_backward_reference,
        gat_round_reference)
    t_phase = time.perf_counter()
    ds, reached = data["ds"], data["rung_batches"]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    largest = reached[max(reached)]
    rungs = sorted(set(reached) | set(FORCED_RUNGS))
    worst = {"forward": 0.0, "backward": 0.0}
    names = ("d_xw", "d_alpha_l", "d_alpha_r", "d_alpha_e", "d_ins")
    for npg, epg in rungs:
        idx = reached.get((npg, epg), largest)
        samples = _filled([ds[int(i)]["graph"] for i in idx[:B]], npg, epg,
                          seed=npg + epg)
        g = pack_graphs_dense(samples, npg, epg).to(dev)
        dl, sl = dense_local_indices(g)
        mask = g.edge_mask.reshape(B, epg).float()
        gen = torch.Generator(device=dev).manual_seed(npg + epg)
        randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
        N = B * npg
        base = (dl, sl, mask, randn(N, H), randn(N, H), randn(B, epg, H))
        xw32, ins32, grad32 = randn(N, H, C), randn(B, H, C), randn(N, C)
        keep = (torch.rand(B, epg, H, generator=gen, device=dev)
                >= DROPOUT).float() / (1.0 - DROPOUT)
        parts = []
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            xw, ins, grad = xw32.to(dtype), ins32.to(dtype), grad32.to(dtype)
            kw = dict(npg=npg, epg=epg)
            got = gat_round(*base, xw, ins, keep_scale=keep, **kw)
            want = gat_round_reference(*base, xw.float(), ins.float(),
                                       keep_scale=keep, **kw)
            bgot = gat_round_backward(grad, *base, xw, ins, keep, **kw)
            bwant = gat_round_backward_reference(
                grad.float(), *base, xw.float(), ins.float(), keep, **kw)
            torch.cuda.synchronize()
            atol, rtol = TOL[name]
            diff = (got.float() - want).abs()
            f_err = float(diff.max())
            if (not torch.isfinite(got).all()
                    or bool((diff > atol + rtol * want.abs()).any())):
                fail(f"gat_round at rung ({npg}, {epg}) {name}: max abs err "
                     f"{f_err:.3e}")
            b_err = 0.0
            for out_name, gb, wb in zip(names, bgot, bwant):
                batol, brtol = (TOL[name] if out_name in ("d_xw", "d_ins")
                                else BWD_F32_TOL)
                d = (gb.float() - wb.float()).abs()
                b_err = max(b_err, float(d.max()))
                if (not torch.isfinite(gb).all()
                        or bool((d > batol + brtol * wb.float().abs()).any())):
                    fail(f"gat_round_backward at rung ({npg}, {epg}) {name}: "
                         f"{out_name} max abs err {float(d.max()):.3e}")
            f_ms = device_median_ms(
                lambda: gat_round(*base, xw, ins, keep_scale=keep, **kw),
                "gat_round_kernel", flush, reps=10)
            b_ms = device_median_ms(
                lambda: gat_round_backward(grad, *base, xw, ins, keep, **kw),
                "gat_round_backward_kernel", flush, reps=10)
            if f_ms is None or b_ms is None:
                fail(f"torch.profiler recorded no kernel time at rung "
                     f"({npg}, {epg})")
            worst["forward"] = max(worst["forward"], f_err)
            worst["backward"] = max(worst["backward"], b_err)
            parts.append(f"{name} fwd err {f_err:.2e} {f_ms * 1e3:.1f}us, "
                         f"bwd err {b_err:.2e} {b_ms * 1e3:.1f}us")
        log(f"[ladder] rung ({npg}, {epg}) B={B} "
            f"{'reached' if (npg, epg) in reached else 'forced'}, real "
            f"edges {int(mask.sum())}: " + "; ".join(parts))
    log(f"[ladder] {len(rungs)} rungs, worst err forward "
        f"{worst['forward']:.2e} backward {worst['backward']:.2e}; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    return worst


def _last_match(pattern, text, what):
    found = re.findall(pattern, text)
    if not found:
        fail(f"the CLI printed no {what}")
    return found[-1]


def _run_cli(args, name, timeout=600):
    """Run the port's train CLI (or scorer) as a subprocess; its output goes
    to build/chip_smoke/<name>.log; non-zero exit fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout,
                          cwd=pathlib.Path(__file__).resolve().parent)
    (SMOKE_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"{name} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


def phase_cli(cfg, dev, data):
    """Phase 11: the port's train CLI at full width, then a forced flat
    batch through the eval and train steps."""
    t_phase = time.perf_counter()
    root, out = data["data"], SMOKE_DIR / "cli"
    rounds = cfg.model.engine.num_rounds
    common = ["graphvqa_tpu_torch.cli.train_cli", "--data-root", str(root),
              "--batch-size", str(B), "--workers", "2", "--validate-every",
              "1", "--fast-validate", "2", "--print-freq", "1",
              "--output_dir", str(out)]
    train_out, train_s = _run_cli(common + ["--epochs", "1"], "cli_train")
    steps = 4096 // B
    if steps < 2:
        fail("phase 11 needs at least two train steps")
    m = re.findall(r"epoch sustained: ([\d.]+) qa/s, \S+ edges/s, data-wait "
                   r"([\d.]+)% \(([\d.]+)s wall\)", train_out)
    if not m:
        fail("the CLI printed no epoch summary")
    qa_s, wait, wall = (float(v) for v in m[-1])
    # the meters print cumulative QA/s after every step (--print-freq 1):
    # the wall time at the end of step i is B * (i + 1) / rate_i
    ends = [B * (i + 1) / float(r) for i, r in enumerate(re.findall(
        r"  throughput: ([\d.]+) qa/s", train_out))]
    if len(ends) != steps:
        fail(f"the CLI printed {len(ends)} step throughputs for {steps} "
             f"steps")
    steady_ms = 1e3 * (ends[-1] - ends[0]) / (steps - 1)
    layouts = json.loads(_last_match(
        r"collate layout stats \(this epoch\): (\{.*\})", train_out,
        "layout stats").replace("'", '"'))
    tr = cli_launches(train_out, "train epoch 0")
    kernel_steps = steps - layouts["flat_fallback"]
    ln_fwd, ln_bwd, ln_eval = layer_norm_launches(cfg)
    if tr != kernel_launches(
            gat_round=rounds * kernel_steps,
            gat_round_backward=rounds * kernel_steps,
            layer_norm=ln_fwd * steps, layer_norm_backward=ln_bwd * steps):
        fail(f"CLI epoch: {launch_text(tr)} launches for {steps} steps, "
             f"{kernel_steps} dense, expected gat_round and "
             f"gat_round_backward {rounds} each per dense step, layer_norm "
             f"{ln_fwd} and layer_norm_backward {ln_bwd} per step")
    shapes, warm, caps, cap_s, replays = _last_match(
        r"step graphs \(train epoch 0\): (\d+) shapes, (\d+) warm-ups, "
        r"(\d+) captures \(([\d.]+)s\), (\d+) replays", train_out,
        "train step graphs")
    if int(warm) + int(replays) != steps:
        fail(f"CLI epoch: {warm} warm-ups and {replays} graph replays for "
             f"{steps} steps")
    graphs_line = (f"{shapes} shapes, {warm} warm-ups, {caps} captures "
                   f"({cap_s}s), {replays} replays")
    val_q = int(_last_match(r"eval sustained: [\d.]+ qa/s \((\d+) questions",
                            train_out, "validation summary"))
    val = cli_launches(train_out, "validate epoch 0")
    batches = -(-val_q // B)
    if val != kernel_launches(gat_round=rounds * batches,
                              layer_norm=ln_eval * batches):
        fail(f"CLI validation: {launch_text(val)} launches for {val_q} "
             f"questions")
    if not (out / "ckpt" / "ckpt_0.pt").exists():
        fail("the CLI wrote no checkpoint")
    eval_out, eval_s = _run_cli(common + [
        "--resume", str(out / "ckpt"), "--evaluate", "--dump-result",
        "--dump-attentions"], "cli_evaluate")
    if "resumed from" not in eval_out:
        fail("the CLI did not resume from its checkpoint")
    ev = re.findall(r"eval sustained: ([\d.]+) qa/s \((\d+) questions, "
                    r"([\d.]+)s wall\)", eval_out)
    if not ev:
        fail("the CLI printed no evaluation summary")
    eval_qa_s, eval_q = float(ev[-1][0]), int(ev[-1][1])
    ev = cli_launches(eval_out, "evaluate val_balanced")
    batches = -(-eval_q // B)
    if ev != kernel_launches(gat_round=rounds * batches,
                             layer_norm=ln_eval * batches):
        fail(f"CLI evaluate: {launch_text(ev)} launches for {eval_q} "
             f"questions")
    dump = json.loads((out / "dump_results.json").read_text())
    atts = json.loads((out / "dump_attentions.json").read_text())
    if len(dump) != eval_q or len(atts) != eval_q:
        fail(f"dumps hold {len(dump)} results / {len(atts)} attentions for "
             f"{eval_q} questions")
    score_out, _ = _run_cli([
        "graphvqa_tpu_torch.eval.scorer", "--questions",
        str(root / "questions" / "val_balanced_questions.json"),
        "--predictions", str(out / "dump_results.json"), "--grounding",
        "--attentions", str(out / "dump_attentions.json"), "--scenes",
        str(root / "sceneGraphs" / "val_sceneGraphs.json")], "cli_scorer")
    accuracy = _last_match(r"(Accuracy: [\d.]+%)", score_out,
                           "scorer accuracy")
    grounding = _last_match(r"(Grounding: [\d.]+%)", score_out,
                            "scorer grounding")
    log(f"[cli] train epoch at full width, B={B}, workers 2: {steps} steps "
        f"in {wall:.2f}s wall = {steps / wall:.2f} steps/s, {qa_s:.1f} QA/s "
        f"(the first step, with the pool's fork and the card's warm-up, "
        f"{ends[0]:.2f}s; then {steady_ms:.1f} ms per step = "
        f"{1e3 / steady_ms:.2f} steps/s, {B * 1e3 / steady_ms:.1f} QA/s), "
        f"data-wait {wait:.1f}%, layouts {layouts}, launches "
        f"{launch_text(tr)}, step graphs {graphs_line}; "
        f"validation {val_q} questions, "
        f"{launch_text(val)}; process {train_s:.1f}s")
    log(f"[cli] --resume --evaluate: {eval_q} questions at {eval_qa_s:.1f} "
        f"QA/s, launches {launch_text(ev)}, dumps {len(dump)} results / "
        f"{len(atts)} attention rows; process {eval_s:.1f}s; scorer "
        f"{accuracy}, {grounding}")
    phase_flat(cfg, dev, data)
    log(f"[cli] phase {time.perf_counter() - t_phase:.1f}s")
    return dict(
        forward=tr["gat_round"] + val["gat_round"] + ev["gat_round"],
        backward=tr["gat_round_backward"],
        layer_norm=tr["layer_norm"] + val["layer_norm"] + ev["layer_norm"],
        layer_norm_backward=tr["layer_norm_backward"])


def phase_flat(cfg, dev, data):
    """One batch forced into the flat layout (B=8 of the val split with the
    dense padding at 2 nodes / 8 edges, beyond the ladder): the eval step
    card against CPU as phase 4 holds it, and a train step on the card."""
    import dataclasses
    import torch
    from graphvqa_tpu_torch.data import GQADataset, build_scene_graph_vocab
    from graphvqa_tpu_torch.data.vocab import Vocab
    from graphvqa_tpu_torch.train.loop import make_eval_step, make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    root = data["data"]
    text_vocab = Vocab.load(SMOKE_DIR / "cli" / "text_vocab.json")
    sg_vocab = build_scene_graph_vocab()
    model_cfg = dataclasses.replace(
        cfg.model,
        text=dataclasses.replace(cfg.model.text, vocab_size=len(text_vocab)),
        scene=dataclasses.replace(cfg.model.scene, vocab_size=len(sg_vocab)))
    fcfg = dataclasses.replace(cfg, model=model_cfg, batch=dataclasses.replace(
        cfg.batch, num_graphs=8, nodes_per_graph=2, edges_per_graph=8,
        nodes_pad=1024, edges_pad=8192))
    ds = GQADataset(root / "questions" / "val_balanced_programs.json",
                    root / "sceneGraphs" / "val_sceneGraphs.json", text_vocab,
                    sg_vocab)
    meta, batch = next(ds.iter_batches(fcfg.batch))
    if meta["layout"] != "flat_fallback" or batch.graphs.has_dense_layout:
        fail(f"the forced batch came out {meta['layout']}")
    outs = {}
    for device in ("cpu", dev):
        model = full_model(fcfg, device)
        f0 = launch_counts()
        vectors, tokens, attention = make_eval_step(model, fcfg)(
            batch.to(device))
        outs[str(device)] = model.sample(batch.to(device)).short_answer_logits \
            .float().cpu()
        if device != "cpu":
            since = launches_since(f0)
            if since["gat_round"] or since["gat_round_backward"]:
                fail("the flat batch launched the GAT kernel")
            gen = torch.Generator(device=device).manual_seed(0)
            _, m = make_train_step(model, fcfg)(create_train_state(model),
                                               batch.to(device), gen)
            loss = float(m["total"])
            if not math.isfinite(loss):
                fail(f"flat train step on the card: loss {loss}")
        del model
    g, c = outs[str(dev)], outs["cpu"]
    if g.shape != (8, cfg.model.num_answers) or not torch.isfinite(g).all():
        fail("flat batch: card logits of the wrong shape or not finite")
    err = float((g - c).abs().max())
    same = g.argmax(-1) == c.argmax(-1)
    top2 = c.topk(2, dim=-1).values
    close = (top2[:, 0] - top2[:, 1]) <= PARITY_ATOL
    if err > PARITY_ATOL or bool((~same & ~close).any()):
        fail(f"flat batch: card and CPU logits differ by {err:.4f}")
    log(f"[cli] forced flat batch (B=8, {int(batch.graphs.node_mask.sum())} "
        f"nodes / {int(batch.graphs.edge_mask.sum())} edges in "
        f"{batch.graphs.nodes_pad} / {batch.graphs.edges_pad} slots): "
        f"max |logit card - cpu| {err:.4f} (limit {PARITY_ATOL}), argmax "
        f"equal on {int(same.sum())}/8; train step on the card loss "
        f"{loss:.5f}; no GAT kernel launched (the flat round is plain "
        f"ops)")


FAMILIES = ("gcn", "gine", "lcgn", "onlysg", "exec")


def family_config(name):
    """The named configuration: a CONFIG_FACTORY entry, or "exec":
    gat_config() with the execution engine and its bitmap loss."""
    import dataclasses
    from graphvqa_tpu_torch.config import CONFIG_FACTORY
    if name != "exec":
        return CONFIG_FACTORY[name]()
    c = CONFIG_FACTORY["gat"]()
    return dataclasses.replace(
        c, model=dataclasses.replace(c.model, use_execution_engine=True),
        train=dataclasses.replace(c.train, use_bitmap_loss=True))


def phase_families(dev, data):
    """Phase 12: every other model family at full width (gcn, gine, lcgn,
    onlysg, and gat with the execution engine): card against CPU in bf16
    and in one f32 train step, then the eval and train steps at B=512 with
    their GAT-kernel launch counts; then one CLI epoch of lcgn with the
    execution engine."""
    import torch
    launches = {}
    for name in FAMILIES:
        t0 = time.perf_counter()
        cfg = family_config(name)
        tag = f"families {name}"
        model = full_model(cfg, dev)
        log(f"[{tag}] engine {cfg.model.engine.kind}, execution engine "
            f"{cfg.model.use_execution_engine}, losses: program "
            f"{cfg.train.use_program_loss}, bitmap {cfg.train.use_bitmap_loss};"
            f" params {sum(p.numel() for p in model.parameters())} dtype "
            f"{cfg.model.dtype}")
        phase_parity(cfg, dev, model, tag=tag, relative=True)
        del model
        phase_train_parity(dev, cfg, tag=tag)
        model = full_model(cfg, dev)
        ctx = torch.Generator(device=dev).manual_seed(2)
        serve, _, _ = phase_serve(cfg, dev, model, tag=tag, ctx=ctx,
                                  relative=True)
        train = phase_train(cfg, dev, model, steps=3, tag=tag, ctx=ctx,
                            top=5)
        launches[name] = dict(
            forward=serve["gat_round"] + train["gat_round"],
            backward=train["gat_round_backward"],
            layer_norm=serve["layer_norm"] + train["layer_norm"],
            layer_norm_backward=train["layer_norm_backward"],
            gine_messages=serve["gine_messages"] + train["gine_messages"],
            gine_messages_backward=train["gine_messages_backward"],
            lcgn_rows=serve["lcgn_rows"] + train["lcgn_rows"],
            lcgn_linear=serve["lcgn_linear"] + train["lcgn_linear"],
            lcgn_linear_backward=train["lcgn_linear_backward"])
        log(f"[{tag}] launches: serve {launch_text(serve)} (3 requests), "
            f"train {launch_text(train)} (3 steps); "
            f"{time.perf_counter() - t0:.1f}s")
        del model
        torch.cuda.empty_cache()
    phase_cli_lcgn(data)
    return launches


def phase_cli_lcgn(data):
    """The CLI with --model lcgn --use-execution-engine at full width: one
    epoch of 2 steps (the 1,024 val questions at B=512) and a 1-batch
    validation: LCGN's generator, the program loss, the bitmap BCE and the
    bitmap meters end to end."""
    t0 = time.perf_counter()
    root, out = data["data"], SMOKE_DIR / "cli_lcgn"
    stdout, secs = _run_cli([
        "graphvqa_tpu_torch.cli.train_cli", "--model", "lcgn",
        "--use-execution-engine", "--data-root", str(root), "--split",
        "val_balanced", "--val-split", "val_balanced", "--batch-size", str(B),
        "--epochs", "1", "--validate-every", "1", "--fast-validate", "1",
        "--print-freq", "1", "--output_dir", str(out)], "cli_lcgn_exec")
    losses = [float(v) for v in re.findall(r"Loss (\S+) \(", stdout)]
    if not losses or not all(map(math.isfinite, losses)):
        fail(f"lcgn CLI: training losses {losses}")
    tr = cli_launches(stdout, "train epoch 0")
    want = step_launches(family_config("lcgn"), train=True)
    if tr != scaled(want, 2):
        fail(f"lcgn CLI: {launch_text(tr)} launches in 2 steps, expected "
             f"{launch_text(want)} per step")
    res = _last_match(r"val_balanced (\{.*'bitmap_recall'.*\})", stdout,
                      "validation result with the bitmap meters")
    qa_s = _last_match(r"epoch sustained: ([\d.]+) qa/s", stdout,
                       "epoch summary")
    if not (out / "ckpt" / "ckpt_0.pt").exists():
        fail("lcgn CLI: no checkpoint")
    log(f"[families cli] lcgn + execution engine, B={B}: losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}, epoch {qa_s} QA/s, "
        f"validation {res}, launches {launch_text(tr)}; process "
        f"{secs:.1f}s, phase "
        f"{time.perf_counter() - t0:.1f}s")


# --- phase 14: the steps as CUDA graphs ---------------------------------------

def rung_batch(cfg, data, rung, seed):
    """A B=512 request at ``rung`` (npg, epg): the graphs of a batch that
    phase 9's collate put there (their edges; tokens drawn as gqa_samples
    draws them, in the model's vocabularies), the token streams as qa_batch
    makes them."""
    import dataclasses
    import numpy as np
    from graphvqa_tpu_torch.core.packing import pack_graphs_dense
    ds, idx = data["ds"], data["rung_batches"][rung]
    rng = np.random.default_rng(seed)
    samples = []
    for i in idx[:B]:
        g = ds[int(i)]["graph"]
        samples.append(dataclasses.replace(
            g, exec_bitmap=None,
            node_tokens=rng.integers(2, 2000, size=(
                len(g.node_tokens), 12)).astype(np.int32),
            edge_tokens=rng.integers(2, 2000, size=(
                len(g.edge_src), 1)).astype(np.int32)))
    graphs = pack_graphs_dense(samples, *rung,
                               max_steps=cfg.model.max_execution_steps)
    return qa_batch(cfg, B, seed, graphs=graphs)


def _outputs_diff(a, b):
    """(all equal bit for bit, largest |difference|) of two nests of
    tensors."""
    import torch
    flat_a, flat_b = [], []
    for x, out in ((a, flat_a), (b, flat_b)):
        stack = [x]
        while stack:
            v = stack.pop()
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, dict):
                stack.extend(v[k] for k in sorted(v))
            else:
                stack.extend(v)
    equal = len(flat_a) == len(flat_b) and all(
        torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    diff = max(float((x.double() - y.double()).abs().max())
               for x, y in zip(flat_a, flat_b))
    return equal, diff


def graphs_train_parity(dev, tag):
    """Per family (gat and FAMILIES): three float32 train steps with
    dropout on, B=512 at full width, captured (warm-up, capture, replay)
    against eager, from the same weights and generator seeds (LCGN's
    context generator too), under deterministic algorithms: the loss of
    each step, then every parameter, gradient and running statistic after
    the third, bitwise, or else within phase 8's limits. -> {family:
    dict(bitwise, max_diff)}"""
    import dataclasses
    import torch
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    out = {}
    for name in ("gat",) + FAMILIES:
        base = family_config(name)
        cfg = dataclasses.replace(base, model=dataclasses.replace(
            base.model, dtype="float32"))
        lcgn = cfg.model.engine.kind == "lcgn"
        batches = [qa_batch(cfg, B, seed=300 + i).to(dev) for i in range(3)]
        runs = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for mode in ("captured", "eager"):
                model = full_model(cfg, dev)
                state = create_train_state(
                    model, lr=cfg.train.lr,
                    weight_decay=cfg.train.weight_decay)
                step = make_train_step(model, cfg,
                                       capture=mode == "captured")
                gen = torch.Generator(device=dev).manual_seed(5)
                ctx = (torch.Generator(device=dev).manual_seed(6) if lcgn
                       else None)
                losses = []
                for batch in batches:
                    state, m = step(state, batch, gen, ctx)
                    losses.append(float(m["total"]))
                torch.cuda.synchronize()
                runs[mode] = dict(step_record(model, state, m),
                                  losses=losses)
                if mode == "captured" and (
                        step.graphs.warm_ups, step.graphs.captures,
                        step.graphs.replays) != (1, 1, 2):
                    fail(f"{tag} {name}: the f32 steps ran "
                         f"{step.graphs.warm_ups} warm-ups, "
                         f"{step.graphs.captures} captures and "
                         f"{step.graphs.replays} replays, not 1, 1, 2")
                del model, state, step
                torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
        cap, eag = runs["captured"], runs["eager"]
        keys = ("params", "grads", "stats")
        equal, diff = _outputs_diff([cap[k] for k in keys],
                                    [eag[k] for k in keys])
        equal = equal and cap["losses"] == eag["losses"]
        if not equal:
            held = hold_train_step(eag, cap, f"{tag} {name}", "captured",
                                   "eager")
            for i, (a, b) in enumerate(zip(cap["losses"], eag["losses"])):
                if abs(a - b) > TRAIN_LOSS_RTOL * abs(b):
                    fail(f"{tag} {name}: f32 step {i}: captured loss {a} "
                         f"eager {b}")
        log(f"[{tag}] {name} f32 train, 3 steps with dropout "
            f"{cfg.model.transformer.dropout}/{cfg.model.engine.dropout}/"
            f"{cfg.model.classifier_dropout}"
            + (" and LCGN's context draws" if lcgn else "")
            + f", captured (warm-up, capture, replay) against eager: losses "
            f"{cap['losses']} / {eag['losses']}; "
            + ("parameters, gradients and running statistics bitwise equal"
               if equal else f"not bitwise (largest difference "
               f"{diff:.3e}); phase 8's limits: {held}"))
        out[name] = dict(bitwise=equal, max_diff=diff)
    return out


def graphs_rungs_parity(cfg, dev, model, batches, tag):
    """The main rung and a bumped one interleaved, bf16 at full width under
    deterministic algorithms: a train step then an eval request on each of
    ``batches`` ((rung, batch) pairs), captured against eager from the same
    state and generator (rewound in place). The captured run warms up and
    captures each rung's graphs once, then replays the rungs out of their
    capture order, every graph in the one pool: each step's loss and eval
    outputs, then every parameter, gradient and running statistic, bitwise.
    -> the captured run's (warm-ups, captures, replays) of the train step"""
    import torch
    from graphvqa_tpu_torch.train.loop import make_eval_step, make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    state = create_train_state(model, lr=cfg.train.lr,
                               weight_decay=cfg.train.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(9)
    rewind = rewind_point(state, (gen,))
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for capture in (True, False):
            rewind()
            train = make_train_step(model, cfg, capture=capture)
            evaluate = make_eval_step(model, cfg, capture=capture)
            losses, answers = [], []
            for _, batch in batches:
                _, m = train(state, batch, gen)
                losses.append(float(m["total"]))
                answers.append([t.cpu() for t in _flat(evaluate(batch))])
            rec = step_record(model, state, m)
            runs[capture] = dict(rec, losses=losses, answers=answers)
            if capture:
                calls = (train.graphs.warm_ups, train.graphs.captures,
                         train.graphs.replays)
                if (evaluate.graphs.warm_ups, evaluate.graphs.captures,
                        evaluate.graphs.replays) != calls:
                    fail(f"{tag}: the eval step's graph calls differ from "
                         f"the train step's {calls}")
            del train, evaluate
    finally:
        torch.use_deterministic_algorithms(False)
    cap, eag = runs[True], runs[False]
    rungs = " ".join(str(r) for r, _ in batches)
    for i, (a, b) in enumerate(zip(cap["answers"], eag["answers"])):
        if not _outputs_diff(a, b)[0]:
            fail(f"{tag}: step {i} ({batches[i][0]}): the captured eval "
                 f"request differs from the eager one")
    keys = ("params", "grads", "stats")
    equal, diff = _outputs_diff([cap[k] for k in keys],
                                [eag[k] for k in keys])
    if not equal or cap["losses"] != eag["losses"]:
        fail(f"{tag}: rungs {rungs} interleaved: captured losses "
             f"{cap['losses']}, eager {eag['losses']}; state bitwise "
             f"{equal} (largest difference {diff:.3e})")
    log(f"[{tag}] bf16 rungs interleaved ({rungs}) under deterministic "
        f"algorithms, captured against eager from one rewound state: train "
        f"warm-ups, captures, replays {calls}; losses {cap['losses']}; "
        f"every eval request, the losses, parameters, gradients and running "
        f"statistics bitwise equal")
    del state, rewind
    return calls


def _flat(x):
    """The tensors of a nest of tensors, dicts (in key order), tuples and
    lists."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    return [t for v in x for t in _flat(v)]


def train_tensors(state):
    """Every tensor a train step updates in place: the parameters, the
    buffers (running statistics), Adam's moments and count."""
    opt = state.opt_state
    return (list(state.model.parameters()) + list(state.model.buffers())
            + list(opt["mu"].values()) + list(opt["nu"].values())
            + [opt["count"]])


def rewind_point(state, gens):
    """-> a function that puts the train state's tensors back to what they
    hold now, in place (a graph holds their addresses), with the host's
    step count and the generators' states."""
    import torch
    tensors = train_tensors(state)
    saved = [t.detach().clone() for t in tensors]
    gens = [g for g in gens if g is not None]
    gen_states = [g.get_state() for g in gens]
    step = state.step

    def rewind():
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        for g, v in zip(gens, gen_states):
            g.set_state(v)
        state.step = step

    return rewind


def step_gaps(got, ref):
    """(largest gradient difference over its tensor's largest |gradient|,
    where that exceeds 1e-5; largest updated-parameter difference where
    ref's |gradient| > 1e-5) of two step_record()s."""
    grad, param = 0.0, 0.0
    for n, gr_ in ref["grads"].items():
        scale = float(gr_.abs().max())
        if scale > 1e-5:
            grad = max(grad, float((got["grads"][n] - gr_).abs().max())
                       / scale)
        cond = gr_.abs() > 1e-5
        if bool(cond.any()):
            param = max(param, float(
                (got["params"][n] - ref["params"][n])[cond].abs().max()))
    return grad, param


def hold_train_replays(cfg, state, step, batches, gen, ctx, tag):
    """One replay of ``step``'s graph per batch, each against the eager step
    from the same state and generators (rewound in place): the loss within
    phase 8's TRAIN_LOSS_RTOL. The eager step's own gradients differ from
    run to run at B=512 (atomic sums in its backward), so the replay's
    gradient and parameter differences from the eager step are printed
    beside those of a second eager run from the same point; phase 14 holds
    the whole state bitwise under deterministic algorithms. -> text"""
    from graphvqa_tpu_torch.train.loop import make_train_step
    eager = make_train_step(state.model, cfg, capture=False)
    rows = []
    for i, batch in enumerate(batches):
        rewind = rewind_point(state, (gen, ctx))
        replays = step.graphs.replays
        _, m = step(state, batch, gen, ctx)
        if step.graphs.replays != replays + 1:
            fail(f"{tag}: a held train step did not replay its graph")
        got = step_record(state.model, state, m)
        runs = []
        for _ in range(2):
            rewind()
            _, m = eager(state, batch, gen, ctx)
            runs.append(step_record(state.model, state, m))
        want, again = runs
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        if not math.isfinite(got["loss"]) or rel > TRAIN_LOSS_RTOL:
            fail(f"{tag}: replay {i}: loss {got['loss']} against the eager "
                 f"step's {want['loss']} (rel {rel:.2e}, limit "
                 f"{TRAIN_LOSS_RTOL})")
        (g_cap, p_cap), (g_eag, p_eag) = (step_gaps(got, want),
                                          step_gaps(again, want))
        rows.append(
            f"replay {i}: loss {got['loss']:.7f} / eager {want['loss']:.7f}"
            f" ({'bitwise' if got['loss'] == want['loss'] else f'rel {rel:.1e}'}"
            f"); gradients {g_cap:.2e} of their scale (eager against eager "
            f"{g_eag:.2e}), updated params {p_cap:.2e} ({p_eag:.2e})")
    return "; ".join(rows)


def hold_eval_replays(cfg, model, step, requests, ctx, tag, relative):
    """One replay of ``step``'s graph per request, each against the eager
    step on it from the same generator state (LCGN's ``ctx``), within
    phase 4's limits (phase 12's with ``relative``): the top logit within
    PARITY_ATOL (times max(1, the eager logits' largest |value|)), the
    greedy answer equal but for near ties of the eager logits, the bitmap
    within PARITY_ATOL; bitwise equality, the top logit's largest
    difference and the program tokens' agreement reported. -> text"""
    import dataclasses
    import torch
    from graphvqa_tpu_torch.train.loop import make_eval_step
    eager = make_eval_step(model, cfg, capture=False)
    rows = []
    for i, req in enumerate(requests):
        saved = None if ctx is None else ctx.get_state()

        def rewound(fn):
            if ctx is not None:
                ctx.set_state(saved)
            return fn()

        replays = step.graphs.replays
        got = step(req, ctx)
        if step.graphs.replays != replays + 1:
            fail(f"{tag}: a held request did not replay its graph")
        want = rewound(lambda: eager(req, ctx))
        with torch.inference_mode():
            logits = rewound(lambda: model.sample(dataclasses.replace(
                req, programs=req.programs[:, :-1],
                full_answers=req.full_answers[:, :-1]), ctx_generator=ctx)
            ).short_answer_logits.float()
        equal, _ = _outputs_diff(got, want)
        (gv, gt, _), (wv, wt, _) = got, want
        limit = PARITY_ATOL * (max(1.0, float(logits.abs().max()))
                               if relative else 1.0)
        err = float((gv["sa_score"].float() - wv["sa_score"].float())
                    .abs().max())
        top2 = logits.topk(2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= limit
        differ = gv["sa_pred"] != wv["sa_pred"]
        if err > limit or bool((differ & ~near).any()):
            fail(f"{tag}: replay {i} against the eager request: top logit "
                 f"{err:.4f} (limit {limit:.4f}), {int(differ.sum())} answers "
                 f"differ ({int((differ & ~near).sum())} not near ties)")
        extra = ""
        if "execution_bitmap" in wv:
            real = req.graphs.node_mask
            b_err = float((gv["execution_bitmap"].float()
                           - wv["execution_bitmap"].float())[real].abs().max())
            if b_err > PARITY_ATOL:
                fail(f"{tag}: replay {i}: bitmap differs from the eager "
                     f"request's by {b_err:.4f}")
            extra = f", bitmap {b_err:.4f}"
        tok = float((gt == wt).float().mean())
        rows.append(f"replay {i}: " + ("bitwise" if equal else
                    f"top logit {err:.4f} (limit {limit:.4f}), answers "
                    f"differ on {int(differ.sum())} (near ties "
                    f"{int((differ & near).sum())}), tokens agree "
                    f"{tok:.4f}{extra}"))
    return "; ".join(rows)


def timed_steps(fn, n):
    """ms of ``n`` calls of ``fn`` after an untimed one (the allocator's
    cache refills after a capture emptied it), each ending in a
    synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_graphs(dev, data):
    """Phase 14: the train and eval steps as CUDA graphs at full width,
    B=512: every family's f32 train steps captured against eager (bitwise,
    deterministic algorithms); the main and a bumped rung interleaved,
    captured against eager (bitwise, deterministic algorithms); then the
    graphs the port runs: ms per step captured and eager, each one's device
    busy time and host launch calls, the GAT launches per step counted where
    the kernels ran, a bumped rung's second graph, capture seconds per
    rung, peak memory, and the main rung's replays held against the eager
    step between the bumped rung's."""
    import torch
    from graphvqa_tpu_torch.config import gat_config
    from graphvqa_tpu_torch.train.loop import make_eval_step, make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    tag = "graphs"
    t_phase = time.perf_counter()
    out = dict(train_parity=graphs_train_parity(dev, tag))
    cfg = gat_config()
    main = (NPG, EPG)
    above = [r for r in data["rung_batches"] if r[0] * r[1] > NPG * EPG]
    if not above:
        fail(f"{tag}: phase 9 reached no rung above {main}")
    bumped = min(above, key=lambda r: (r[0] * r[1], r))
    model = full_model(cfg, dev)
    mains = [qa_batch(cfg, B, seed=510 + i).to(dev) for i in range(3)]
    bigs = [rung_batch(cfg, data, bumped, seed=500 + i).to(dev)
            for i in range(2)]
    calls = graphs_rungs_parity(cfg, dev, model, [
        (main, mains[0]), (main, mains[1]), (bumped, bigs[0]),
        (bumped, bigs[1]), (main, mains[2]), (bumped, bigs[0]),
        (main, mains[0])], tag)
    if calls != (2, 2, 5):
        fail(f"{tag}: the interleaved rungs ran (warm-ups, captures, "
             f"replays) {calls}, expected (2, 2, 5)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    # the graphs the port runs: eval, then train, on the main rung
    requests = [qa_batch(cfg, B, seed=400 + i).to(dev) for i in range(3)]
    cap_eval = make_eval_step(model, cfg)
    eager_eval = make_eval_step(model, cfg, capture=False)
    for req in requests[:2]:            # the warm-up, then the capture
        cap_eval(req)
    reset_launch_counts()
    eval_ms = {"captured": timed_steps(lambda: cap_eval(requests[1]), 3)}
    eval_launches = launch_counts()
    per_request = step_launches(cfg, train=False)
    if eval_launches != scaled(per_request, 4):
        fail(f"{tag}: {launch_text(eval_launches)} launches in 4 replayed "
             f"requests, expected {launch_text(per_request)} per request")
    eval_ms["eager"] = timed_steps(lambda: eager_eval(requests[1]), 3)
    eval_prof = {mode: profiled_step(lambda: step(requests[1]),
                                     f"{tag} eval {mode}", 5)
                 for mode, step in (("captured", cap_eval),
                                    ("eager", eager_eval))}

    state = create_train_state(model, lr=cfg.train.lr,
                               weight_decay=cfg.train.weight_decay)
    cap_train = make_train_step(model, cfg)
    eager_train = make_train_step(model, cfg, capture=False)
    batch = qa_batch(cfg, B, seed=200).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):                  # the warm-up, then the capture
        cap_train(state, batch, gen)
    reset_launch_counts()
    train_ms = {"captured": timed_steps(
        lambda: cap_train(state, batch, gen), 5)}
    train_launches = launch_counts()
    per_step = step_launches(cfg, train=True)
    if train_launches != scaled(per_step, 6):
        fail(f"{tag}: {launch_text(train_launches)} launches in 6 replayed "
             f"train steps, expected {launch_text(per_step)} per step")
    train_ms["eager"] = timed_steps(lambda: eager_train(state, batch, gen), 5)
    train_prof = {mode: profiled_step(lambda: step(state, batch, gen),
                                      f"{tag} train {mode}", 5)
                  for mode, step in (("captured", cap_train),
                                     ("eager", eager_train))}
    peak = peak_gib(dev)

    # a bumped rung captures a second graph; the main rung then replays,
    # each replay held against the eager step between the bumped rung's
    for _ in range(2):
        cap_train(state, bigs[0], gen)
        cap_eval(bigs[0])
    before = (cap_train.graphs.captures, cap_eval.graphs.captures)
    held = []
    for i in range(2):
        cap_train(state, bigs[1], gen)
        cap_eval(bigs[1])
        held.append(hold_train_replays(cfg, state, cap_train, [mains[i]],
                                       gen, None, tag))
        cap_eval(bigs[0])
        held.append(hold_eval_replays(cfg, model, cap_eval, [requests[i]],
                                      None, tag, relative=False))
    after = (cap_train.graphs.captures, cap_eval.graphs.captures)
    if before != (2, 2) or after != before or (
            len(cap_train.graphs.graphs), len(cap_eval.graphs.graphs)) != (2, 2):
        fail(f"{tag}: captures {before} after the bumped rung and {after} "
             f"after the main rung's replays; graphs "
             f"{len(cap_train.graphs.graphs)} / {len(cap_eval.graphs.graphs)}"
             f", expected 2 and 2, 2 / 2")
    torch.cuda.synchronize()
    # each step's keys in capture order: the main rung, then the bumped one
    capture_s = {name: dict(zip((str(main), str(bumped)), (
        round(v, 3) for v in graphs.capture_seconds.values())))
        for name, graphs in (("train", cap_train.graphs),
                             ("eval", cap_eval.graphs))}

    def summary(ms):
        return (f"{', '.join(f'{v:.2f}' for v in ms)} (mean "
                f"{statistics.mean(ms):.2f})")

    for name, times, prof in (("eval", eval_ms, eval_prof),
                              ("train", train_ms, train_prof)):
        parts = []
        for mode in ("captured", "eager"):
            p = prof[mode] or {}
            parts.append(
                f"{mode} {summary(times[mode])} ms/step, profiled: wall "
                f"{p.get('wall_ms', float('nan')):.2f} ms, device busy "
                f"{p.get('busy_ms', float('nan')):.2f} ms, "
                f"{p.get('kernels', 0)} kernels, "
                f"{p.get('host_launches', 0)} host launch calls")
        log(f"[{tag}] {name} B={B} bf16: " + "; ".join(parts))
    log(f"[{tag}] main rung {main} replays between the bumped rung's "
        f"{bumped}, against the eager step: train {held[0]}; eval "
        f"{held[1]}; train {held[2]}; eval {held[3]}")
    log(f"[{tag}] capture seconds per rung: {capture_s}; bumped rung "
        f"{bumped} captured a second graph each, the main rung "
        f"{main} then replayed (captures {after}); launches counted on "
        f"the card under replay: eval {launch_text(per_request)} per "
        f"request, train {launch_text(per_step)} per step; peak "
        f"memory with both main-rung graphs cached {peak}, with the bumped "
        f"rung's too {peak_gib(dev)}; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    del model, state
    torch.cuda.empty_cache()
    out.update(eval_forward=eval_launches, train=train_launches)
    return out


# --- phase 13: the multi-device paths ----------------------------------------

MULTI_DIR = SMOKE_DIR / "multi"


def phase_shard_kernels(dev):
    """13a: both kernels against their plain versions on edge rank 0's share
    of phase 2's B=512 batch, sharded by destination over K=2 and K=4 ranks
    (the shapes (npg, epg_loc) that an edge-sharded step gives them), in
    f32 and bf16, with the 'graph' shift given as the max over all K shares
    (graph_logit_max, as the edge-sharded GAT layer passes it); max error
    and cold-L2 device time beside the least-bytes bound."""
    import torch
    from graphvqa_tpu_torch.core.native import shard_edges_by_dst_native
    from graphvqa_tpu_torch.ops.dense import dense_local_indices
    from graphvqa_tpu_torch.ops.gat_round import (
        gat_round, gat_round_backward, gat_round_backward_reference,
        gat_round_reference, graph_logit_max)
    from graphvqa_tpu_torch.parallel.edge_sharded import local_shard
    base = kernel_inputs(dev)
    al, ar = base["al"], base["ar"]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    names = ("d_xw", "d_alpha_l", "d_alpha_r", "d_alpha_e", "d_ins")
    graph = pack_main_graph()
    results = {}
    for k in (2, 4):
        gen = torch.Generator(device=dev).manual_seed(10 + k)
        sharded = shard_edges_by_dst_native(graph, k)
        shares = []
        for e in range(k):
            g = local_shard(sharded, e, None).to(dev)
            dl, sl = dense_local_indices(g)
            epg = g.edges_per_graph
            shares.append((dl, sl, g.edge_mask.reshape(B, epg).float(),
                           torch.randn(B, epg, H, generator=gen, device=dev)))
        gmax = torch.stack([graph_logit_max(dl, sl, m, al, ar, ae, npg=NPG)
                            for dl, sl, m, ae in shares]).amax(dim=0)
        dl, sl, mask, ae = shares[0]
        epg = dl.shape[1]
        args = (dl, sl, mask, al, ar, ae)
        inp = dict(base, dl=dl, sl=sl, mask=mask)
        grad32 = torch.randn(B * NPG, C, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            xw, ins = base["xw32"].to(dtype), base["ins32"].to(dtype)
            grad = grad32.to(dtype)
            kw = dict(npg=NPG, epg=epg, shift_max=gmax)
            got = gat_round(*args, xw, ins, **kw)
            want = gat_round_reference(*args, xw.float(), ins.float(), **kw)
            bgot = gat_round_backward(grad, *args, xw, ins, None, **kw)
            bwant = gat_round_backward_reference(
                grad.float(), *args, xw.float(), ins.float(), None, **kw)
            torch.cuda.synchronize()
            atol, rtol = TOL[name]
            diff = (got.float() - want).abs()
            f_err = float(diff.max())
            if (not torch.isfinite(got).all()
                    or bool((diff > atol + rtol * want.abs()).any())):
                fail(f"gat_round on a K={k} share {name}: max abs err "
                     f"{f_err:.3e}")
            b_err = 0.0
            for out_name, gb, wb in zip(names, bgot, bwant):
                batol, brtol = (TOL[name] if out_name in ("d_xw", "d_ins")
                                else BWD_F32_TOL)
                d = (gb.float() - wb.float()).abs()
                b_err = max(b_err, float(d.max()))
                if (not torch.isfinite(gb).all()
                        or bool((d > batol + brtol * wb.float().abs()).any())):
                    fail(f"gat_round_backward on a K={k} share {name}: "
                         f"{out_name} max abs err {float(d.max()):.3e}")
            f_ms = device_median_ms(lambda: gat_round(*args, xw, ins, **kw),
                                    "gat_round_kernel", flush)
            b_ms = device_median_ms(
                lambda: gat_round_backward(grad, *args, xw, ins, None, **kw),
                "gat_round_backward_kernel", flush)
            if f_ms is None or b_ms is None:
                fail(f"torch.profiler recorded no kernel time on a K={k} "
                     f"share")
            b_bytes, n_edges, n_dst = backward_least_bytes(
                inp, dtype.itemsize, False, epg)
            f_bytes = least_bytes(inp, dtype.itemsize, True, epg)
            f_flops = (2 * H * C + 12 * H) * n_edges + 2 * H * C * n_dst
            b_flops = 4 * H * C * n_edges + 4 * H * C * n_dst + 24 * H * n_edges
            bounds = {}
            for way, nbytes, flops in (("forward", f_bytes, f_flops),
                                       ("backward", b_bytes, b_flops)):
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_F32_FLOPS * 1e3
                bounds[way] = (max(t_bytes, t_ops),
                               "bytes" if t_bytes >= t_ops else "operations")
            results[(k, name)] = dict(
                epg=epg, forward_err=f_err, backward_err=b_err,
                forward_ms=f_ms, backward_ms=b_ms, bounds=bounds)
            log(f"[multi kernels] K={k} share 0 at (npg, epg_loc) = ({NPG}, "
                f"{epg}), B={B}, {n_edges} real edges, {name}: forward err "
                f"{f_err:.2e} device {f_ms * 1e3:.2f}us cold-L2 (bound "
                f"{bounds['forward'][0] * 1e3:.2f}us, "
                f"{100 * bounds['forward'][0] / f_ms:.1f}%); backward err "
                f"{b_err:.2e} device {b_ms * 1e3:.2f}us (bound "
                f"{bounds['backward'][0] * 1e3:.2f}us, "
                f"{100 * bounds['backward'][0] / b_ms:.1f}%)")
    return results


def f32_config(base):
    """``base`` in float32 with every dropout 0 (phase 8's check step)."""
    import dataclasses
    mc = base.model
    return dataclasses.replace(base, model=dataclasses.replace(
        mc, dtype="float32", classifier_dropout=0.0,
        transformer=dataclasses.replace(mc.transformer, dropout=0.0),
        engine=dataclasses.replace(mc.engine, dropout=0.0)))


def step_record(model, state, m, seconds=0.0):
    """A train step's result on the CPU: loss, each parameter's own .grad
    (zeros for none), the parameters and the running statistics."""
    import torch
    return dict(
        loss=float(m["total"]), seconds=seconds,
        grads={n: (p.grad if p.grad is not None
                   else torch.zeros_like(p)).cpu()
               for n, p in model.named_parameters()},
        params={n: p.detach().cpu() for n, p in model.named_parameters()},
        stats={n: b.cpu() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))},
        metrics={k: float(v) for k, v in m.items()})


def _rank_main(rank, world, cases, backend):
    """A spawned rank: ``backend`` (gloo, or nccl for one rank) on the one
    card, the cases in order."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{MULTI_DIR}/store{world}{backend}",
        rank=rank, world_size=world)
    try:
        for case in cases:
            RANK_CASES[case["kind"]](rank, case)
    finally:
        dist.destroy_process_group()


def _rank_check(rank, case):
    """One float32 step of the data-parallel or edge-sharded train step on
    this rank's batch, under deterministic algorithms; saves its record
    (with the rank's own pre-reduce gradient) and the ReLU pins."""
    import torch
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_dp_edge_train_step, prepare_dp_edge_batch)
    from graphvqa_tpu_torch.parallel.mesh import data_seed, make_mesh
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = torch.device("cuda", 0)
    mesh = make_mesh(case["data"], case["edge"])
    cfg = case["cfg"]
    model = full_model(cfg, dev)
    batch = qa_batch(cfg, case["batch"], seed=case["seed"] + mesh.data_rank)
    rows = None
    if mesh.edge > 1:
        rows = share_edge_rows(batch.graphs, mesh).to(dev)
        batch = prepare_dp_edge_batch([batch], mesh)[0]
    batch = batch.to(dev)
    pins = []
    if case.get("relu_ref"):
        _, pins = watch_relu_inputs(
            model, torch.load(case["relu_ref"], weights_only=False),
            f"multi {case['name']} rank {rank}", edge_rows=rows)
    state = create_train_state(model, lr=cfg.train.lr)
    step = make_dp_edge_train_step(model, cfg, mesh, capture=False)
    gen = torch.Generator(device=dev).manual_seed(data_seed(0, mesh))
    torch.use_deterministic_algorithms(True, warn_only=True)
    _, m = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    rec = step_record(model, state, m)
    rec.update(pins=pins, epg_loc=batch.graphs.edges_per_graph)
    if case.get("captured"):
        del step
        if case.get("relu_ref"):
            # the ReLU hooks hold the check step's record only: the held
            # steps start from a fresh model of the same seed
            del state, model
            torch.cuda.empty_cache()
            model = full_model(cfg, dev)
            state = create_train_state(model, lr=cfg.train.lr)
            gen = torch.Generator(device=dev).manual_seed(data_seed(0, mesh))
        tag = f"multi {case['name']} rank {rank}"
        batches = [qa_batch(cfg, case["batch"], seed=case["seed"] + 10 * i
                            + mesh.data_rank) for i in (1, 2, 3)]
        if mesh.edge > 1:
            batches = prepare_dp_edge_batch(batches, mesh)
        batches = [b.to(dev) for b in batches]
        rec["captured"] = hold_dp_capture(cfg, mesh, state, batches, gen,
                                          tag)
        if mesh.edge > 1:
            rec["eval"] = hold_edge_eval_capture(cfg, mesh, model,
                                                 batches[0], tag)
    torch.save(rec, MULTI_DIR / f"{case['name']}_rank{rank}.pt")


def dp_record(state, metrics):
    """A DP run's end on the CPU: step_record's and Adam's moments, with
    every step's metrics."""
    rec = step_record(state.model, state, metrics[-1])
    rec.update(metrics=metrics, **{
        k: {n: t.cpu() for n, t in state.opt_state[k].items()}
        for k in ("mu", "nu")})
    return rec


@contextlib.contextmanager
def counted_all_reduces(calls):
    """Each Python call of dist.all_reduce appended to the list
    ``calls[-1]`` as (op, shape, dtype), in call order."""
    import torch.distributed as dist
    all_reduce = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        calls[-1].append((str(kwargs.get("op", dist.ReduceOp.SUM)),
                          tuple(tensor.shape), str(tensor.dtype)))
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = counted
    try:
        yield
    finally:
        dist.all_reduce = all_reduce


def in_graph(mesh) -> bool:
    """Whether the mesh's collectives run inside the step's graph (every
    group NCCL) rather than on the host between two graphs (gloo)."""
    import torch.distributed as dist
    return all(dist.get_backend(g) == "nccl"
               for g in (mesh.world_group, mesh.edge_group) if g is not None)


def hold_collectives(mesh, eager, captured, tag):
    """Fails unless each call of a captured step (warm-up, capture, then
    replays) made the eager step's dist.all_reduce calls (``eager``, one
    call's list of (op, shape, dtype)), in number and order: every call
    through gloo, where each is a host call between two graphs; the
    warm-up and the capture over NCCL, whose replays issue none."""
    want = [eager] * min(len(captured), 2) + [
        [] if in_graph(mesh) else eager] * (len(captured) - 2)
    if captured != want:
        fail(f"{tag}: the captured calls' dist.all_reduce calls "
             f"{[len(c) for c in captured]} differ from the eager step's "
             f"{len(eager)} in number or order (op, shape, dtype)")


def hold_dp_capture(cfg, mesh, state, batches, gen, tag):
    """Three float32 steps of make_dp_train_step on ``batches`` (edge
    shares with an edge axis), eager and then captured (warm-up, capture,
    replay) from the same state and generator (rewound in place), under
    deterministic algorithms, the eager run's cache freed before the
    capture: every step's metrics, the parameters, this rank's own
    gradients, Adam's moments and the running statistics, bitwise. Holds
    the Python calls of dist.all_reduce of each captured step to the eager
    step's (hold_collectives: over NCCL the replay issues none, the
    collectives are inside the graph). -> dict(graphs (warm-ups, captures,
    replays), segments, all_reduces {captured, eager} per step, capture_s,
    peak)"""
    import torch
    from graphvqa_tpu_torch.parallel.data_parallel import make_dp_train_step
    rewind = rewind_point(state, (gen,))
    runs, reduces = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("eager", "captured"):
            rewind()
            torch.cuda.empty_cache()
            step = make_dp_train_step(state.model, cfg, mesh,
                                      capture=mode == "captured")
            metrics, reduces[mode] = [], []
            with counted_all_reduces(reduces[mode]):
                for batch in batches:
                    reduces[mode].append([])
                    _, m = step(state, batch, gen)
                    metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            runs[mode] = dp_record(state, metrics)
            graphs = step.graphs
            del step
    finally:
        torch.use_deterministic_algorithms(False)
    calls = (graphs.warm_ups, graphs.captures, graphs.replays)
    if calls != (1, 1, 2):
        fail(f"{tag}: the captured steps ran (warm-ups, captures, "
             f"replays) {calls}, expected (1, 1, 2)")
    hold_collectives(mesh, reduces["eager"][0], reduces["captured"], tag)
    cap, eag = runs["captured"], runs["eager"]
    keys = ("params", "grads", "stats", "mu", "nu")
    equal, diff = _outputs_diff([cap[k] for k in keys],
                                [eag[k] for k in keys])
    if not equal or cap["metrics"] != eag["metrics"]:
        fail(f"{tag}: captured steps against eager: metrics equal "
             f"{cap['metrics'] == eag['metrics']}, state bitwise {equal} "
             f"(largest difference {diff:.3e})")
    return dict(graphs=calls, segments=list(graphs.segments.values()),
                all_reduces={k: [len(c) for c in v]
                             for k, v in reduces.items()},
                capture_s=sum(graphs.capture_seconds.values()),
                losses=[m["total"] for m in cap["metrics"]],
                peak=peak_gib(torch.device("cuda", 0)))


def hold_edge_eval_capture(cfg, mesh, model, batch, tag):
    """Three float32 requests of make_edge_eval_step on ``batch``, captured
    (warm-up, capture, replay), each against the eager request bitwise
    under deterministic algorithms; the dist.all_reduce calls of each held
    to the eager request's (hold_collectives). -> dict(graphs, segments,
    all_reduces {captured, eager} per request, capture_s)"""
    import torch
    from graphvqa_tpu_torch.parallel.edge_sharded import make_edge_eval_step
    reduces = {"eager": [[]], "captured": []}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with counted_all_reduces(reduces["eager"]):
            want = make_edge_eval_step(model, cfg, mesh, capture=False)(batch)
        step = make_edge_eval_step(model, cfg, mesh)
        outs = []
        with counted_all_reduces(reduces["captured"]):
            for _ in range(3):
                reduces["captured"].append([])
                outs.append(step(batch))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    graphs = step.graphs
    calls = (graphs.warm_ups, graphs.captures, graphs.replays)
    if calls != (1, 1, 2):
        fail(f"{tag} eval: (warm-ups, captures, replays) {calls}, expected "
             f"(1, 1, 2)")
    hold_collectives(mesh, reduces["eager"][0], reduces["captured"],
                     f"{tag} eval")
    for i, got in enumerate(outs):
        equal, diff = _outputs_diff(got, want)
        if not equal:
            fail(f"{tag} eval: captured request {i} against eager differs "
                 f"by {diff:.3e}")
    return dict(graphs=calls, segments=list(graphs.segments.values()),
                all_reduces={k: [len(c) for c in v]
                             for k, v in reduces.items()},
                capture_s=sum(graphs.capture_seconds.values()))


def _rank_nccl(rank, case):
    """The DP step, or with ``edge`` the edge-sharded step and request, on
    a one-rank NCCL group given as the mesh's world group (and edge group;
    make_mesh leaves a world of one without a group; the batches sharded
    at K=1), so every collective is issued and captured inside the step's
    one graph: three float32 steps held bitwise against eager
    (hold_dp_capture; the edge request: hold_edge_eval_capture), then bf16
    steps captured (the warm-up, the capture, ``steps`` counted replays)
    and eager (1 warm-up, ``steps`` counted): ms per step, GAT launches
    counted on the card; with ``edge`` the bf16 request too."""
    import torch
    import torch.distributed as dist
    from graphvqa_tpu_torch.parallel.edge_sharded import prepare_dp_edge_batch
    from graphvqa_tpu_torch.parallel.mesh import Mesh
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = torch.device("cuda", 0)
    group = dist.group.WORLD
    edge = case.get("edge", False)
    mesh = Mesh(data=1, edge=1, rank=0, world_group=group,
                edge_group=group if edge else None)
    backend = dist.get_backend(mesh.world_group)

    def batches_at(cfg, seeds):
        out = [qa_batch(cfg, case["batch"], seed=case["seed"] + i)
               for i in seeds]
        if edge:
            out = prepare_dp_edge_batch(out, mesh)
        return [b.to(dev) for b in out]

    cfg32, cfg = case["cfg32"], case["cfg"]
    tag = f"multi {case['name']} ({backend})"
    model = full_model(cfg32, dev)
    state = create_train_state(model, lr=cfg32.train.lr)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = batches_at(cfg32, range(3))
    rec = dict(backend=backend, check=hold_dp_capture(
        cfg32, mesh, state, batches, gen, tag))
    if edge:
        rec["eval_check"] = hold_edge_eval_capture(cfg32, mesh, model,
                                                   batches[0], tag)
    del model, state, batches
    torch.cuda.empty_cache()
    model = full_model(cfg, dev)
    state = create_train_state(model, lr=cfg.train.lr)
    batch, = batches_at(cfg, [9])
    for mode, untimed in (("captured", 2), ("eager", 1)):
        rec[mode] = time_dp_steps(cfg, mesh, state, batch, gen, mode,
                                  untimed, case["steps"])
        if edge:
            rec[f"{mode}_eval"] = time_edge_eval(cfg, mesh, model, batch,
                                                 mode, case["steps"])
    rec["peak"] = peak_gib(dev)
    torch.save(rec, MULTI_DIR / f"{case['name']}_rank{rank}.pt")


def share_edge_rows(graphs, mesh):
    """[B*epg_loc] int64: the batch's edge index of each slot of this edge
    rank's share (-1 on padding), by sharding the edge indices themselves
    in place of the edge tokens."""
    import dataclasses
    import torch
    from graphvqa_tpu_torch.core.native import shard_edges_by_dst_native
    from graphvqa_tpu_torch.parallel.edge_sharded import local_shard
    ids = torch.arange(graphs.edges_pad, dtype=torch.int32)[:, None]
    share = local_shard(shard_edges_by_dst_native(
        dataclasses.replace(graphs, edge_tokens=ids), mesh.edge),
        mesh.edge_rank, None)
    return torch.where(share.edge_mask, share.edge_tokens[:, 0].long(), -1)


def time_dp_steps(cfg, mesh, state, batch, gen, mode, untimed, steps,
                  profile=None):
    """``steps`` timed calls of make_dp_train_step ("captured" or "eager")
    after ``untimed`` ones, the GAT launches (counts set to 0 just before,
    read just after) and the Python calls of dist.all_reduce per step
    counted over them (each one's op, shape and dtype in order); with
    ``profile`` (a tag) then one profiled step and the peak memory.
    -> dict(times, losses, launches, reduces, reduce_calls[, prof,
    peak][, calls, capture_s, segments])"""
    import torch
    from graphvqa_tpu_torch.parallel.data_parallel import make_dp_train_step
    step = make_dp_train_step(state.model, cfg, mesh,
                              capture=mode == "captured")
    for _ in range(untimed):
        step(state, batch, gen)
    torch.cuda.synchronize()
    times, losses, calls = [], [], []
    reset_launch_counts()
    with counted_all_reduces(calls):
        for _ in range(steps):
            calls.append([])
            t0 = time.perf_counter()
            _, m = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["total"]))
    out = dict(times=times, losses=losses, launches=launch_counts(),
               reduces=[len(c) for c in calls], reduce_calls=calls)
    if profile is not None:
        out["prof"] = profiled_step(lambda: step(state, batch, gen),
                                    f"{profile} {mode}", 0)
        out["peak"] = peak_gib(torch.device("cuda", 0))
    out.update(graph_counts(step.graphs))
    return out


def graph_counts(graphs):
    """A step's graph calls (warm-ups, captures, replays), capture seconds
    and segments per key; nothing for an eager step."""
    if graphs is None:
        return {}
    return dict(calls=(graphs.warm_ups, graphs.captures, graphs.replays),
                capture_s=sum(graphs.capture_seconds.values()),
                segments=list(graphs.segments.values()))


def time_edge_eval(cfg, mesh, model, batch, mode, n, profile=None):
    """``n`` timed requests of make_edge_eval_step ("captured": after the
    warm-up and the capture; "eager": after one warm-up), with the GAT
    launches and the dist.all_reduce calls per request counted over them;
    with ``profile`` then one profiled request and the peak memory since
    the last reset. -> time_dp_steps' dict, without losses"""
    import torch
    from graphvqa_tpu_torch.parallel.edge_sharded import make_edge_eval_step
    step = make_edge_eval_step(model, cfg, mesh, capture=mode == "captured")
    for _ in range(2 if mode == "captured" else 1):
        step(batch)
    torch.cuda.synchronize()
    times, calls = [], []
    reset_launch_counts()
    with counted_all_reduces(calls):
        for _ in range(n):
            calls.append([])
            t0 = time.perf_counter()
            vec, _, _ = step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(vec["sa_score"].float()).all()):
        fail(f"edge eval {mode}: non-finite scores")
    out = dict(times=times, launches=launch_counts(),
               reduces=[len(c) for c in calls], reduce_calls=calls)
    if profile is not None:
        out["prof"] = profiled_step(lambda: step(batch),
                                    f"{profile} eval {mode}", 0)
        out["peak"] = peak_gib(torch.device("cuda", 0))
    out.update(graph_counts(step.graphs))
    return out


def _rank_time(rank, case):
    """bf16 train steps at full width on this rank's batch: 1 warm-up and
    ``steps`` counted eager ones, the GAT launches and the Python calls of
    dist.all_reduce counted over them; with ``captured``, then the same
    through the captured step (the eager run's cache freed first: the
    warm-up, the capture, ``steps`` counted replays), and one profiled step
    of each; with ``eval``, then the edge eval request eager and captured
    the same way; then the step's one all-reduce alone on a buffer of its
    size."""
    import torch
    import torch.distributed as dist
    from graphvqa_tpu_torch.parallel.data_parallel import StepReduce
    from graphvqa_tpu_torch.parallel.edge_sharded import prepare_dp_edge_batch
    from graphvqa_tpu_torch.parallel.mesh import data_seed, make_mesh
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = torch.device("cuda", 0)
    mesh = make_mesh(case["data"], case["edge"])
    cfg = case["cfg"]
    model = full_model(cfg, dev)
    batch = qa_batch(cfg, case["batch"], seed=case["seed"] + mesh.data_rank)
    if mesh.edge > 1:
        batch = prepare_dp_edge_batch([batch], mesh)[0]
    batch = batch.to(dev)
    tc = cfg.train
    state = create_train_state(model, lr=tc.lr, weight_decay=tc.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(data_seed(0, mesh))
    profile = (f"multi {case['name']} rank {rank}" if case.get("captured")
               else None)
    rec = time_dp_steps(cfg, mesh, state, batch, gen, "eager",
                        1 if case["warmup"] else 0, case["steps"], profile)
    if case.get("captured"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        rec["captured"] = time_dp_steps(cfg, mesh, state, batch, gen,
                                        "captured", 2, case["steps"], profile)
    if case.get("eval"):
        for mode in ("eager", "captured"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            rec[f"{mode}_eval"] = time_edge_eval(cfg, mesh, model, batch,
                                                 mode, case["steps"], profile)
    # the step's one all-reduce alone, on a buffer of the gradients' and
    # statistics' size (and none of the step's tensors)
    sizes = StepReduce(model, mesh)
    flat = torch.zeros(sizes.n_grad + sizes.n_stat, device=dev)
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=mesh.world_group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    rec.update(epg_loc=batch.graphs.edges_per_graph,
               reduce_ms=statistics.median(reduce_ms),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    torch.save(rec, MULTI_DIR / f"{case['name']}_rank{rank}.pt")


RANK_CASES = {"check": _rank_check, "time": _rank_time,
              "nccl": _rank_nccl}


def run_ranks(world, cases, backend="gloo"):
    """``cases`` on ``world`` spawned ranks sharing the card; each rank's
    saved results by case name."""
    import torch
    import torch.multiprocessing as mp
    (MULTI_DIR / f"store{world}{backend}").unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(_rank_main, args=(world, cases, backend),
                       nprocs=world, join=True, start_method="spawn")
    out = {c["name"]: [torch.load(MULTI_DIR / f"{c['name']}_rank{r}.pt",
                                  weights_only=False) for r in range(world)]
           for c in cases}
    log(f"[multi] {world} ranks over {backend} on one card: "
        f"{', '.join(c['name'] for c in cases)} in "
        f"{time.perf_counter() - t0:.1f}s")
    return out


def reference_step(cfg, dev, batch, relu_record=None):
    """The single-process float32 train step on the card under
    deterministic algorithms (``relu_record``: where to save its ReLU
    inputs for watch_relu_inputs)."""
    import torch
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    model = full_model(cfg, dev)
    record = watch_relu_inputs(model)[0] if relu_record else None
    state = create_train_state(model, lr=cfg.train.lr)
    torch.use_deterministic_algorithms(True, warn_only=True)
    _, m = make_train_step(model, cfg)(
        state, batch.to(dev), torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    rec = step_record(model, state, m)
    if relu_record:
        torch.save(record, relu_record)
    del model, state
    torch.cuda.empty_cache()
    return rec


def _run_text(run, unit="step"):
    """A timed run's text: ms per call, the dist.all_reduce calls per
    call, the profiled call, the graph counts, segments and peak."""
    text = (f"ms/{unit} {', '.join(f'{t * 1e3:.2f}' for t in run['times'])}"
            + (f", loss {', '.join(f'{v:.5f}' for v in run['losses'])}"
               if "losses" in run else "")
            + f", dist.all_reduce calls per {unit} {run['reduces']}")
    prof = run.get("prof")
    if prof is not None:
        text += (f", profiled: wall {prof['wall_ms']:.2f} ms, device "
                 f"busy {prof['busy_ms']:.2f} ms, "
                 f"{prof['host_launches']} host launch calls")
    if "calls" in run:
        text += (f", (warm-ups, captures, replays) {run['calls']}, "
                 f"graphs per {unit} {run['segments']}, capture "
                 f"{run['capture_s']:.3f}s")
    if "peak" in run:
        text += f", peak {run['peak']}"
    return text


def _hold_run(tag, mode, run, launches, collectives):
    """Fails on kernel launches other than ``launches`` (step_launches)
    per call, on a non-finite loss, or on a call whose dist.all_reduce
    calls differ from ``collectives`` (a list of (op, shape, dtype)) in
    number or order: the eager call's own, or none for a replay whose
    graph holds its collectives (NCCL)."""
    n = len(run["times"])
    if run["launches"] != scaled(launches, n):
        fail(f"{tag} {mode}: {launch_text(run['launches'])} launches in {n} "
             f"calls, expected {launch_text(launches)} per call")
    if not all(map(math.isfinite, run.get("losses", []))):
        fail(f"{tag} {mode}: non-finite loss {run['losses']}")
    if run["reduce_calls"] != [collectives] * n:
        fail(f"{tag} {mode}: dist.all_reduce calls per call "
             f"{run['reduces']} differ from the expected {len(collectives)} "
             f"in number or order (op, shape, dtype)")


def _timing_line(tag, runs, cfg):
    """Per-rank ms per step and launches of a 'time' case, its captured run
    beside the eager one where it has one (host launch calls, graphs per
    step, capture seconds, peak memory), and its edge eval requests where
    it has them; fails (_hold_run) on a non-finite loss, on launches other
    than ``cfg``'s per rank per step in either run (step_launches; per
    request on the requests), or on a captured run whose collectives
    differ from the eager step's own in number or order. -> the kernel
    launches of the run the path takes: the captured one where there is
    one."""
    per_step = step_launches(cfg, train=True)
    per_request = step_launches(cfg, train=False)
    total = kernel_launches()
    for r, rec in enumerate(runs):
        eager = rec["reduce_calls"][0]
        modes = ([("captured", rec["captured"])] if "captured" in rec
                 else []) + [("eager", rec)]
        texts = []
        for mode, run in modes:
            # through gloo every replay makes the eager step's collectives
            _hold_run(f"{tag} rank {r}", mode, run, per_step, eager)
            texts.append(f"{mode} " + _run_text(run))
        if "eager_eval" in rec:
            eager = rec["eager_eval"]["reduce_calls"][0]
            for mode in ("captured", "eager"):
                run = rec[f"{mode}_eval"]
                _hold_run(f"{tag} rank {r} eval", mode, run, per_request,
                          eager)
                texts.append(f"eval {mode} " + _run_text(run, "request"))
        for kind, v in modes[0][1]["launches"].items():
            total[kind] += v
        log(f"[{tag}] rank {r}: " + "; ".join(texts) + f"; epg_loc "
            f"{rec['epg_loc']}, the gradient all-reduce alone "
            f"{rec['reduce_ms']:.1f} ms, peak {rec['peak_gib']:.2f} GiB "
            f"allocated in the rank")
    log(f"[{tag}] launches per rank per step {launch_text(per_step)}"
        + (f", per request {launch_text(per_request)}"
           if "eager_eval" in runs[0] else "")
        + ", counted on the card")
    return total


def phase_dp(dev):
    """13b: the data-parallel step, gat_config() at full width, two ranks
    of B=256 on the card over gloo. One float32 eager step: each rank's own
    gradient equals the single-process step on its batch, and the updated
    parameters the average-then-Adam of those two steps (phase 8's limits,
    and 1e-6 of each tensor's scale where |gradient| > 1e-5); the running
    statistics their mean. Then three more float32 steps, captured
    (warm-up, capture, replay) against eager, bitwise on each rank under
    deterministic algorithms. Then bf16 steps, eager (1 warm-up, 3
    counted) and captured (the warm-up, the capture, 3 counted replays):
    ms per step per rank, host launch calls, capture seconds, peak memory,
    the all-reduce calls per step and the GAT launches counted on the card.
    Then the same step on a one-rank NCCL group (_rank_nccl): its
    all-reduce captured inside the graph, bitwise against eager."""
    import torch
    from graphvqa_tpu_torch.config import gat_config
    from graphvqa_tpu_torch.train.train_state import create_train_state
    t0 = time.perf_counter()
    cfg32, cfg = f32_config(gat_config()), gat_config()
    Bd = B // 2
    refs = [reference_step(cfg32, dev, qa_batch(cfg32, Bd, seed=300 + d))
            for d in range(2)]
    avg = {n: (refs[0]["grads"][n] + refs[1]["grads"][n]) / 2
           for n in refs[0]["grads"]}
    model = full_model(cfg32, dev)
    state = create_train_state(model, lr=cfg32.train.lr)
    state.apply_gradients({n: g.to(dev) for n, g in avg.items()})
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, state
    torch.cuda.empty_cache()
    stats = {n: (refs[0]["stats"][n] + refs[1]["stats"][n]) / 2
             for n in refs[0]["stats"]}
    loss = (refs[0]["loss"] + refs[1]["loss"]) / 2
    ranks = run_ranks(2, [
        dict(kind="check", name="dp_check", data=2, edge=1, cfg=cfg32,
             batch=Bd, seed=300, captured=True),
        dict(kind="time", name="dp_time", data=2, edge=1, cfg=cfg, batch=Bd,
             seed=310, warmup=True, steps=3, captured=True)])
    lines = []
    for d, got in enumerate(ranks["dp_check"]):
        ref = dict(refs[d], params=params, stats=stats, loss=loss)
        lines.append(hold_train_step(ref, got, f"multi dp rank {d}",
                                     f"rank {d}", "one process",
                                     cond_grads=avg))
        worst = 0.0
        for n, w in params.items():
            cond = avg[n].abs() > 1e-5
            if bool(cond.any()):
                rel = float((got["params"][n] - w)[cond].abs().max()) / max(
                    float(w.abs().max()), 1e-30)
                worst = max(worst, rel)
        if worst > 1e-6:
            fail(f"multi dp rank {d}: updated parameters differ from the "
                 f"average-then-Adam by {worst:.2e} of a tensor's scale")
        lines[-1] += f"; params {worst:.2e} of their tensor's scale"
    for d, line in enumerate(lines):
        log(f"[multi dp] f32 B={Bd} per rank, rank {d} against one process "
            f"(its own gradient before the reduce; the params against the "
            f"average-then-Adam): {line}")
    for d, got in enumerate(ranks["dp_check"]):
        if got["captured"]["segments"] != [2]:
            fail(f"multi dp rank {d}: graphs per step "
                 f"{got['captured']['segments']}, expected 2 (one cut)")
        if got["captured"]["all_reduces"] != {"eager": [1, 1, 1],
                                              "captured": [1, 1, 1]}:
            fail(f"multi dp rank {d}: dist.all_reduce calls per step "
                 f"{got['captured']['all_reduces']}, expected 1 each")
        log(f"[multi dp] f32 B={Bd} rank {d}, 3 more steps captured against "
            f"eager under deterministic algorithms: {_capture_held(got)}")
    launches = _timing_line(f"multi dp bf16 B={Bd} per rank",
                            ranks["dp_time"], cfg)
    nccl = run_ranks(1, [dict(kind="nccl", name="dp_nccl", cfg32=cfg32,
                              cfg=cfg, batch=Bd, seed=320, steps=3)],
                     backend="nccl")["dp_nccl"][0]
    _nccl_line("multi nccl", nccl, cfg, {"check": 1},
               f"the world group given to the mesh: f32 B={Bd}")
    log(f"[multi dp] phase {time.perf_counter() - t0:.1f}s")
    return launches


def _capture_held(rec):
    """The text of a hold_dp_capture (or hold_edge_eval_capture) result."""
    c = rec["captured"] if "captured" in rec else rec
    text = ("outputs bitwise" if "losses" not in c else
            f"metrics, parameters, own gradients, Adam moments and running "
            f"statistics bitwise; losses "
            f"{', '.join(f'{v:.7f}' for v in c['losses'])}")
    return (f"{text}; (warm-ups, captures, replays) {c['graphs']}; graphs "
            f"per call {c['segments']}; dist.all_reduce calls per call "
            f"{c['all_reduces']}; capture {c['capture_s']:.3f}s"
            + (f"; peak {c['peak']}" if "peak" in c else ""))


def _nccl_line(tag, rec, cfg, collectives, what):
    """Checks and logs a one-rank NCCL case (_rank_nccl): the backend, the
    f32 holds' dist.all_reduce calls (``collectives``: per eager call and
    per capture of each hold, {'check': n[, 'eval_check': m]}; none in a
    replay), and each bf16 run (_hold_run: a replay issues none)."""
    if rec["backend"] != "nccl":
        fail(f"{tag}: the world group's backend is {rec['backend']}")
    for key, n in collectives.items():
        if rec[key]["segments"] != [1]:
            fail(f"{tag}: {key} graphs per call {rec[key]['segments']}, "
                 f"expected 1 (no cut)")
        reduces = rec[key]["all_reduces"]
        if reduces != {"eager": [n] * len(reduces["eager"]),
                       "captured": [n, n, 0]}:
            fail(f"{tag}: dist.all_reduce calls per call {reduces}, "
                 f"expected {n} per eager call and none on the replay (the "
                 f"collectives inside the graph)")
    parts = []
    units = [("", "step", step_launches(cfg, train=True))] + (
        [("_eval", "request", step_launches(cfg, train=False))]
        if "eager_eval" in rec else [])
    for suffix, unit, launches in units:
        eager = rec[f"eager{suffix}"]["reduce_calls"][0]
        for mode in ("captured", "eager"):
            run = rec[f"{mode}{suffix}"]
            _hold_run(f"{tag} {unit}", mode, run, launches,
                      [] if mode == "captured" else eager)
            parts.append(f"{unit} {mode} " + _run_text(run, unit))
    held = _capture_held(rec["check"])
    if "eval_check" in rec:
        held += f"; the request: {_capture_held(rec['eval_check'])}"
    log(f"[{tag}] one rank, {what}, 3 calls captured against eager: {held} "
        f"(the warm-up and the capture issued the collectives, the capture "
        f"into the graph, the replay none from Python); bf16: "
        f"{'; '.join(parts)}; launches per step "
        f"{launch_text(step_launches(cfg, train=True))} counted on the "
        f"card; peak {rec['peak']}")


def phase_edge(dev):
    """13c: the edge-sharded step, gat_config() at full width, B=512 at data
    1 x edge 2. One float32 step against the single-process step on the
    card, held as phase 8 holds the card against the CPU (the ranks' ReLU
    inputs whose sign differs at round-off set to the single process's);
    the two ranks' gradient shares sum to its gradient. Then three more
    float32 steps, captured (warm-up, capture, replay: 19 graphs a step,
    cut at each collective) against eager, and an edge eval request (12
    graphs) captured against eager, bitwise on each rank under
    deterministic algorithms. Then bf16 steps and requests, eager (1
    warm-up, 3 counted) and captured (the warm-up, the capture, 3 counted
    replays): ms, host launch calls, collectives held to the eager call's,
    graphs per call, capture seconds, peak memory, GAT launches counted on
    the card; then one data 2 x edge 2 step on 4 ranks (B=256 per data
    rank), eager, then captured after its warm-up; then the edge step and
    request on a one-rank NCCL group (_rank_nccl), one graph each.
    Returns the GAT launches of the 1 x 2 run and of the 2 x 2 run."""
    import torch
    from graphvqa_tpu_torch.config import gat_config
    t0 = time.perf_counter()
    cfg32, cfg = f32_config(gat_config()), gat_config()
    relu_ref = MULTI_DIR / "edge_relu_ref.pt"
    ref = reference_step(cfg32, dev, qa_batch(cfg32, B, seed=400),
                         relu_record=relu_ref)
    ranks = run_ranks(2, [
        dict(kind="check", name="edge_check", data=1, edge=2, cfg=cfg32,
             batch=B, seed=400, relu_ref=str(relu_ref), captured=True),
        dict(kind="time", name="edge_time", data=1, edge=2, cfg=cfg, batch=B,
             seed=410, warmup=True, steps=3, captured=True, eval=True)])
    relu_ref.unlink()
    r0, r1 = ranks["edge_check"]
    got = dict(r0, grads={n: r0["grads"][n] + r1["grads"][n]
                          for n in r0["grads"]})
    for n in r0["params"]:
        if not torch.equal(r0["params"][n], r1["params"][n]):
            fail(f"multi edge: the two edge ranks' {n} differ after a step")
    line = hold_train_step(ref, got, "multi edge", "edge ranks",
                           "one process")
    pinned = "; ".join(f"rank {r} {n} call {c}: {k} at |x| <= {x:.2e}"
                       for r, run in enumerate((r0, r1))
                       for n, c, k, x in run["pins"]) or "none"
    log(f"[multi edge] f32 B={B} data 1 x edge 2 (epg_loc {r0['epg_loc']}), "
        f"the ranks' summed gradient shares against one process: {line}; "
        f"ReLU inputs set to the single process's sign: {pinned}")
    rounds = gat_rounds(cfg)
    # the forward's MetaLayer assembly and each round's pmax and assembly;
    # a train step adds the backward's assemblies and its all-reduce
    forward = 1 + 2 * rounds
    collectives = forward + 1 + rounds + 1
    for r, run in enumerate((r0, r1)):
        want = {"eager": [collectives] * 3, "captured": [collectives] * 3}
        if run["captured"]["all_reduces"] != want:
            fail(f"multi edge rank {r}: dist.all_reduce calls per step "
                 f"{run['captured']['all_reduces']}, expected {want}")
        segments = (run["captured"]["segments"], run["eval"]["segments"])
        if segments != ([collectives + 1], [forward + 1]):
            fail(f"multi edge rank {r}: graphs per step and per request "
                 f"{segments}, expected one more than the collectives "
                 f"({collectives}, {forward})")
        want = {"eager": [forward], "captured": [forward] * 3}
        if run["eval"]["all_reduces"] != want:
            fail(f"multi edge rank {r}: dist.all_reduce calls per request "
                 f"{run['eval']['all_reduces']}, expected {want}")
        log(f"[multi edge] f32 B={B} rank {r}, 3 more steps captured "
            f"against eager under deterministic algorithms: "
            f"{_capture_held(run)}; an edge eval request, 3 captured "
            f"against eager: {_capture_held(run['eval'])}")
    launches = _timing_line(f"multi edge bf16 B={B} data 1 x edge 2",
                            ranks["edge_time"], cfg)
    grid = run_ranks(4, [dict(kind="time", name="edge_2x2", data=2, edge=2,
                              cfg=cfg, batch=B // 2, seed=420, warmup=False,
                              steps=1, captured=True)])
    more = _timing_line(f"multi edge bf16 data 2 x edge 2, B={B // 2} per "
                        f"data rank, the first step eager, then one "
                        f"captured after its warm-up", grid["edge_2x2"],
                        cfg)
    nccl = run_ranks(1, [dict(kind="nccl", name="edge_nccl", edge=True,
                              cfg32=cfg32, cfg=cfg, batch=B // 2, seed=430,
                              steps=3)], backend="nccl")["edge_nccl"][0]
    _nccl_line("multi edge nccl", nccl, cfg,
               {"check": collectives, "eval_check": forward},
               f"the world and edge group given to the mesh, the batches "
               f"sharded at K=1: f32 B={B // 2}")
    log(f"[multi edge] phase {time.perf_counter() - t0:.1f}s")
    return launches, more


def _run_torchrun(nproc, args, name, timeout=600):
    """The port's train CLI under torchrun (--standalone) with ``nproc``
    ranks; output to build/chip_smoke/<name>.log."""
    return _run_cli(["torch.distributed.run", "--standalone",
                     "--nproc_per_node", str(nproc), "-m",
                     "graphvqa_tpu_torch.cli.train_cli"] + args, name,
                    timeout)


def _rank_graphs(text, what, nproc, tag):
    """Each rank's (shapes, warm-ups, captures, replays) of the CLI's
    'step graphs (<what>, rank r)' lines; fails unless every rank captured
    and replayed."""
    got = []
    for r in range(nproc):
        where = what if nproc == 1 else f"{what}, rank {r}"
        calls = tuple(int(v) for v in _last_match(
            rf"step graphs \({re.escape(where)}\): (\d+) shapes, (\d+) "
            rf"warm-ups, (\d+) captures \([\d.]+s\), (\d+) replays", text,
            f"{where} step graphs"))
        if calls[2] < 1 or calls[3] < 1:
            fail(f"CLI {tag}: {where}: (shapes, warm-ups, captures, "
                 f"replays) {calls}, expected a capture and a replay")
        got.append(calls)
    return got


def phase_cli_dist(data):
    """13d: the CLI under torchrun on phase 9's val split (1,024
    questions): one rank on nccl (an epoch of 2 steps of B=512 with a
    validation, then --resume --evaluate with the dumps), and
    --data-parallel 2 with two ranks sharing the card over gloo (two epochs
    of 2 steps of B=256 per rank, each with a 1-batch validation, then
    --evaluate over both ranks' shards, whose gathered dump must hold every
    val question once), and --data-parallel 1 --edge-parallel 2 with two
    ranks sharing each B=512 batch over gloo (two epochs of 2 steps, each
    with a 1-batch validation, then --evaluate of the 2 batches). Each
    rank of the two-rank runs must capture and replay its train and eval
    steps (the CLI's 'step graphs' lines; an edge share's padding follows
    its batch, so one epoch of 2 steps may hold two shapes and no
    capture)."""
    from graphvqa_tpu_torch.config import gat_config
    t0 = time.perf_counter()
    root = data["data"]
    launches = kernel_launches()
    ln_fwd, ln_bwd, _ = layer_norm_launches(gat_config())
    for tag, nproc, bsz, epochs, extra in (
            ("nccl", 1, B, 1, []),
            ("gloo-dp2", 2, B // 2, 2, ["--data-parallel", "2",
                                        "--dist-backend", "gloo"]),
            ("gloo-edge2", 2, B, 2, ["--data-parallel", "1",
                                     "--edge-parallel", "2",
                                     "--dist-backend", "gloo"])):
        data_ranks = 1 if "--edge-parallel" in extra else nproc
        out = SMOKE_DIR / f"cli_{tag}"
        common = ["--data-root", str(root), "--split", "val_balanced",
                  "--val-split", "val_balanced", "--batch-size", str(bsz),
                  "--print-freq", "1", "--output_dir", str(out)] + extra
        train_out, train_s = _run_torchrun(nproc, common + [
            "--epochs", str(epochs), "--validate-every", "1",
            "--fast-validate", "1"], f"cli_{tag}_train")
        tr = cli_launches(train_out, "train epoch 0")
        steps = 1024 // (bsz * data_ranks)
        if (tr["layer_norm"], tr["layer_norm_backward"]) != (
                ln_fwd * steps, ln_bwd * steps):
            fail(f"CLI {tag}: {launch_text(tr)} launches in epoch 0 of "
                 f"{steps} steps, expected layer_norm {ln_fwd} and "
                 f"layer_norm_backward {ln_bwd} per step")
        losses = [float(v) for v in re.findall(r"Loss (\S+) \(", train_out)]
        if not losses or not all(map(math.isfinite, losses)):
            fail(f"CLI {tag}: training losses {losses}")
        if not (out / "ckpt" / "ckpt_0.pt").exists():
            fail(f"CLI {tag}: no checkpoint")
        eval_out, eval_s = _run_torchrun(nproc, common + [
            "--resume", str(out / "ckpt"), "--evaluate", "--dump-result",
            "--dump-attentions", "--fast-validate",
            str(1024 // (bsz * data_ranks))], f"cli_{tag}_evaluate")
        if "resumed from" not in eval_out:
            fail(f"CLI {tag}: did not resume")
        dump = json.loads((out / "dump_results.json").read_text())
        atts = json.loads((out / "dump_attentions.json").read_text())
        val = json.loads((root / "questions" /
                          "val_balanced_programs.json").read_text())
        want = {str(q[3]) for q in val}
        if set(dump) != want or len(atts) != len(want):
            fail(f"CLI {tag}: the gathered dumps hold {len(dump)} results "
                 f"/ {len(atts)} attention rows for {len(want)} questions")
        res = _last_match(r"val_balanced (\{.*\})", eval_out, "evaluate result")
        for kind, v in tr.items():
            launches[kind] += v
        graphs = ""
        if nproc > 1:
            train_calls, eval_calls = (
                _rank_graphs(train_out, f"{what} epoch {epochs - 1}", nproc,
                             tag) for what in ("train", "validate"))
            # an edge share's padding follows its batch, so the evaluation's
            # two batches may be two shapes, each only warmed up
            evaluate = re.findall(r"step graphs \(evaluate .*", eval_out)
            graphs = (f"; per rank (shapes, warm-ups, captures, replays): "
                      f"train {train_calls}, validation {eval_calls}; "
                      f"evaluate {evaluate}")
        log(f"[multi cli {tag}] torchrun --nproc_per_node {nproc}, B={bsz} "
            f"per rank, {epochs} epoch(s): train losses "
            f"{', '.join(f'{v:.5f}' for v in losses)}, rank 0's launches "
            f"in epoch 0 {launch_text(tr)}; evaluate: "
            f"{len(dump)} results and {len(atts)} attention rows gathered, "
            f"each val question once, {res}{graphs}; processes "
            f"{train_s:.1f}s + {eval_s:.1f}s")
    log(f"[multi cli] phase {time.perf_counter() - t0:.1f}s")
    return launches


def phase_convert(dev, data):
    """13e: a reference-format checkpoint ({'model': state_dict}) of the
    seeded full-width gat model goes through convert_ckpt_cli; the restored
    model gives the saved model's logits on the card, and the CLI's
    --resume --evaluate the saved model's predictions."""
    import argparse
    import torch
    from graphvqa_tpu_torch.cli import convert_ckpt_cli, train_cli
    from graphvqa_tpu_torch.data import (
        GQADataset, build_scene_graph_vocab, build_text_vocab, tokenize)
    from graphvqa_tpu_torch.data.vocab import load_answer_maps
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.train.checkpoint import restore_checkpoint
    from graphvqa_tpu_torch.train.train_state import create_train_state
    t0 = time.perf_counter()
    root, out = data["data"], SMOKE_DIR / "convert"
    out.mkdir(parents=True, exist_ok=True)
    common = ["--data-root", str(root), "--split", "val_balanced",
              "--val-split", "val_balanced", "--batch-size", str(B),
              "--output_dir", str(out)]
    args = train_cli.get_args_parser().parse_args(common)
    programs = root / "questions" / "val_balanced_programs.json"
    text_vocab = build_text_vocab(json.loads(programs.read_text()), tokenize)
    sg_vocab = build_scene_graph_vocab()
    cfg = train_cli.build_config(args, len(text_vocab), len(sg_vocab))
    model = build_model(cfg.model, device=dev, seed=11).eval()
    torch.save({"model": model.state_dict(), "epoch": 2},
               out / "reference.pth")
    parser = argparse.ArgumentParser(
        parents=[convert_ckpt_cli.get_args_parser()])
    convert_ckpt_cli.main(parser.parse_args([
        "--torch-ckpt", str(out / "reference.pth"), "--out",
        str(out / "ckpt")]))
    fresh = build_model(cfg.model, device=dev, seed=12).eval()
    state, start = restore_checkpoint(out / "ckpt", create_train_state(fresh))
    if (state.epoch, start) != (2, 3):
        fail(f"convert: restored epoch {state.epoch}, start {start}")
    ds = GQADataset(programs, root / "sceneGraphs" / "val_sceneGraphs.json",
                    text_vocab, sg_vocab)
    meta, batch = next(iter(ds.iter_batches(cfg.batch)))
    batch = batch.to(dev)
    with torch.inference_mode():
        want = model.sample(batch).short_answer_logits
        got = fresh.sample(batch).short_answer_logits
    if not torch.equal(got, want):
        fail(f"convert: restored logits differ by "
             f"{float((got - want).abs().max()):.3e}")
    eval_out, eval_s = _run_cli(["graphvqa_tpu_torch.cli.train_cli"] + common
                                + ["--resume", str(out / "ckpt"),
                                   "--evaluate", "--dump-result",
                                   "--fast-validate", "1"], "cli_convert")
    if "resumed from" not in eval_out:
        fail("convert: the CLI did not resume the converted checkpoint")
    dump = json.loads((out / "dump_results.json").read_text())
    _, label2ans = load_answer_maps()
    top2 = want.float().topk(2, dim=-1).values
    same = checked = 0
    for b, qid in enumerate(meta["question_ids"]):
        if float(top2[b, 0] - top2[b, 1]) <= PARITY_ATOL:
            continue
        checked += 1
        same += dump[str(qid)]["prediction"] == label2ans[int(
            want[b].argmax())]
    if same != checked or len(dump) != B:
        fail(f"convert: the CLI's predictions match the saved model's on "
             f"{same} of {checked} questions ({len(dump)} dumped)")
    log(f"[multi convert] reference checkpoint -> convert_ckpt_cli -> "
        f"restore: logits equal (bitwise) on B={B}; --resume --evaluate: "
        f"{len(dump)} questions, predictions equal the saved model's on "
        f"{same} of {checked} (those whose top two logits differ by more "
        f"than {PARITY_ATOL}); process {eval_s:.1f}s; phase "
        f"{time.perf_counter() - t0:.1f}s")
    del model, fresh
    torch.cuda.empty_cache()


def phase_multi(dev, data):
    """Phase 13: the multi-device paths on the one card."""
    MULTI_DIR.mkdir(parents=True, exist_ok=True)
    kernels = phase_shard_kernels(dev)
    dp = phase_dp(dev)
    edge, edge_2x2 = phase_edge(dev)
    cli = phase_cli_dist(data)
    phase_convert(dev, data)
    return dict(kernels=kernels, dp=dp, edge=edge, edge_2x2=edge_2x2,
                cli=cli)


# --- phase 15: the Transformer stacks' LayerNorm kernels ---------------------

# the rows of the stacks' LayerNorm calls at B=200, the benchmark's batch:
# the question encoder's 200 x 32, the coarse decoder's 200 x 5, the
# teacher-forced program decoder's 200 x 5 x 16, a greedy step's 200
LN_ROWS, LN_D, LN_EPS = (6400, 1000, 16000, 200), 512, 1e-5
# the backward against autograd through the composite (the card tests'
# limits): dx within one bf16 step (float32: 1e-5 relative) plus
# LN_DX_ATOL of its largest element; dweight and dbias within LN_DW_RTOL
# of the sums of their terms' magnitudes (the same float32 terms over the
# rows in another order)
LN_DX_ATOL, LN_DW_RTOL = 2e-6, 1e-5


def call_ms(fn, flush, reps=20, tries=3):
    """Median device ms of one call of ``fn``: the sum of every kernel it
    launches, from torch.profiler's CUDA events, with ``flush`` (larger
    than the 50 MB L2) inverted before each call, so every call starts from
    a cold L2; the inverting kernels (bitwise_not) mark the calls' bounds
    and are not counted. None when ``tries`` windows recorded no call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            flush.bitwise_not_()
            torch.cuda.synchronize()
        events = sorted((ev.time_range.start, ev.time_range.elapsed_us(),
                         ev.name) for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA)
        calls, current = [], None
        for _, us, name in events:
            if "bitwise_not" in name:
                if current:
                    calls.append(sum(current))
                current = []
            elif current is not None:
                current.append(us)
        if calls:
            return statistics.median(calls) / 1e3
        log(f"[timing] profiler window {attempt + 1} recorded no call; "
            f"profiling again")
    return None


def _ln_backward_readings(got, want, x, dy, stats):
    """dx, dweight and dbias against autograd through the composite, each
    its worst error as a share of its limit (LN_DX_ATOL, LN_DW_RTOL)."""
    import torch
    (dx, dw, db), (dx_ref, dw_ref, db_ref) = got, want
    diff = (dx.float() - dx_ref.float()).abs()
    if dx.dtype == torch.bfloat16:
        big = torch.maximum(dx.float().abs(), dx_ref.float().abs())
        _, exp = torch.frexp(big)
        rel = torch.ldexp(torch.ones_like(big), exp - 8)
    else:
        rel = 1e-5 * dx_ref.float().abs()
    share = {"dx": float((diff / (rel + LN_DX_ATOL * float(
        dx_ref.float().abs().max()))).max())}
    xhat = (x.float() - stats[:, :1]) * stats[:, 1:].abs()
    dyf = dy.float()
    for name, g, r, mag in (("dweight", dw, dw_ref, (dyf * xhat).abs().sum(0)),
                            ("dbias", db, db_ref, dyf.abs().sum(0))):
        share[name] = float(((g - r).abs() / (LN_DW_RTOL * mag + 1e-30)).max())
    return share


def ln_least_bytes(rows, x_elem, y_elem, backward):
    """The fewest bytes a LayerNorm call moves: forward, x read and y
    written once, 8 bytes of statistics a row written, weight and bias read;
    backward, x and dy read and dx written once, the statistics and weight
    read, dweight and dbias written."""
    if backward:
        return rows * LN_D * (2 * x_elem + y_elem) + 8 * rows + 3 * LN_D * 4
    return rows * LN_D * (x_elem + y_elem) + 8 * rows + 2 * LN_D * 4


def phase_layer_norm(dev):
    """Phase 15: the LayerNorm kernels against the plain composite
    (row_layer_norm.layer_norm_reference) on the card, at each of LN_ROWS
    x 512, x in bf16 and in f32, y in bf16: the forward's statistics
    against float64 ones and its y against the composite's within
    torch_port_fixtures.LAYER_NORM_ULPS (layer_norm_errors; the readings
    print beside the composite's own), y the composite's formula at the
    kernel's statistics bit for bit, one launch of each kernel a pass
    counted on the card, the backward against autograd through the
    composite and twice bit for bit; then in bf16 at each row count each
    kernel's cold-L2 device time (the backward's two launches together)
    beside its least-bytes bound, the composite's time (CUDA events) and
    F.layer_norm's (cold L2, weight and bias in bf16)."""
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    from torch_port_fixtures import (LAYER_NORM_ULPS, layer_norm_errors,
                                     layer_norm_stats)
    from graphvqa_tpu_torch.ops import row_layer_norm as rln
    gen = torch.Generator(device=dev).manual_seed(15)
    w = torch.randn(LN_D, generator=gen, device=dev) * 0.5 + 1.0
    b = torch.randn(LN_D, generator=gen, device=dev) * 0.1
    bf16 = torch.bfloat16
    worst = dict.fromkeys(("mean", "rstd", "y.bfloat16", "dx", "dweight",
                           "dbias"), 0.0)
    inputs = {}
    for rows in LN_ROWS:
        x32 = (torch.randn(rows, 1, generator=gen, device=dev) * 0.5
               + torch.randn(rows, LN_D, generator=gen, device=dev)
               * torch.rand(rows, 1, generator=gen, device=dev).mul(2).add(
                   0.5))
        dy = torch.randn(rows, LN_D, generator=gen, device=dev).to(bf16)
        inputs[rows] = (x32.to(bf16), dy)
        for x in (x32.to(bf16), x32):
            name = f"{rows} x {LN_D} {str(x.dtype)[6:]} -> bfloat16"
            runs = []
            for fn in (rln.layer_norm, rln.layer_norm_reference):
                xx, ww, bb = (t.detach().clone().requires_grad_()
                              for t in (x, w, b))
                before = launch_counts()
                y = fn(xx, ww, bb, LN_EPS, bf16)
                y.backward(dy)
                torch.cuda.synchronize()
                since = launches_since(before)
                runs.append((y.detach(), (xx.grad, ww.grad, bb.grad),
                             (since["layer_norm"],
                              since["layer_norm_backward"])))
            (y, grads, counted), (y_ref, grads_ref, _) = runs
            if counted != (1, 1):
                fail(f"layer_norm {name}: one pass through autograd counted "
                     f"{counted} launches, expected (1, 1)")
            _, stats = rln.layer_norm_forward(x, w, b, LN_EPS, bf16,
                                              keep_stats=True)
            read = dict(zip(("mean", "rstd", "y.bfloat16"),
                            layer_norm_errors(x, w, b, stats, y, y_ref)))
            own = layer_norm_errors(x, w, b, layer_norm_stats(x), y_ref,
                                    y_ref)
            formula = ((x.float() - stats[:, :1])
                       * (stats[:, 1:].abs() * w) + b).to(bf16)
            if not torch.equal(y, formula):
                fail(f"layer_norm {name}: y is not the composite's formula "
                     f"at the kernel's own statistics")
            for key, v in read.items():
                if not v <= LAYER_NORM_ULPS[key]:
                    fail(f"layer_norm {name}: {key} error {v:.2f} f32 ulps "
                         f"beyond {LAYER_NORM_ULPS[key]}")
            share = _ln_backward_readings(grads, grads_ref, x, dy, stats)
            for key, v in share.items():
                if not v <= 1.0:
                    fail(f"layer_norm_backward {name}: {key} error at "
                         f"{v:.2f} of its limit")
            first = rln.layer_norm_backward(dy, x, w, stats)
            again = rln.layer_norm_backward(dy, x, w, stats)
            if not all(torch.equal(a, c) for a, c in zip(first, again)):
                fail(f"layer_norm_backward {name}: two runs differ")
            for key, v in {**read, **share}.items():
                worst[key] = max(worst[key], v)
            log(f"[layer-norm] {name}: forward mean {read['mean']:.2f}, "
                f"rstd {read['rstd']:.2f}, y {read['y.bfloat16']:.2f} f32 "
                f"ulps (the composite's statistics: mean {own[0]:.2f}, rstd "
                f"{own[1]:.2f}); y the formula at its statistics bit for "
                f"bit; backward dx {share['dx']:.3f}, dweight "
                f"{share['dweight']:.3f}, dbias {share['dbias']:.3f} of "
                f"their limits, two runs bit for bit")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    timing = {}
    for rows in LN_ROWS:
        x, dy = inputs[rows]
        _, stats = rln.layer_norm_forward(x, w, b, LN_EPS, bf16,
                                          keep_stats=True)
        fwd = lambda: rln.layer_norm_forward(  # noqa: E731
            x, w, b, LN_EPS, bf16, keep_stats=True)
        bwd = lambda: rln.layer_norm_backward(dy, x, w, stats)  # noqa: E731
        xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
        y_plain = rln.layer_norm_reference(xg, wg, bg, LN_EPS, bf16)
        xl, wl, bl = (t.clone().requires_grad_()
                      for t in (x, w.to(bf16), b.to(bf16)))
        y_lib = F.layer_norm(xl, (LN_D,), wl, bl, LN_EPS)
        with torch.no_grad():
            plain_fwd = cuda_median_ms(lambda: rln.layer_norm_reference(
                x, w, b, LN_EPS, bf16))
            lib_fwd = call_ms(lambda: F.layer_norm(
                x, (LN_D,), wl, bl, LN_EPS), flush)
        plain_bwd = cuda_median_ms(lambda: torch.autograd.grad(
            y_plain, (xg, wg, bg), dy, retain_graph=True))
        lib_bwd = call_ms(lambda: torch.autograd.grad(
            y_lib, (xl, wl, bl), dy, retain_graph=True), flush)
        for kind, fn, plain, lib in (("forward", fwd, plain_fwd, lib_fwd),
                                     ("backward", bwd, plain_bwd, lib_bwd)):
            ms = call_ms(fn, flush)
            if ms is None:
                fail(f"torch.profiler recorded no layer_norm {kind} call")
            nbytes = ln_least_bytes(rows, 2, 2, kind == "backward")
            # about 8 and 14 float32 operations an element
            flops = (8 if kind == "forward" else 14) * rows * LN_D
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            timing[(kind, rows)] = dict(
                ms=ms, plain_ms=plain, bound_ms=bound, library_ms=lib,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            host_us = host_us_per_call(fn)
            log(f"[layer-norm] {kind:8s} {rows:5d} x {LN_D} bf16: device "
                f"{ms * 1e3:.2f}us cold-L2 ({100 * bound / ms:.1f}% of "
                f"bound); wrapper host {host_us:.2f}us/call; composite "
                f"{plain * 1e3:.1f}us (events); F.layer_norm "
                + (f"{lib * 1e3:.2f}us cold-L2" if lib is not None
                   else "not recorded")
                + f"; bound {bound * 1e3:.2f}us ({nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.3f} GFLOP)")
    log(f"[layer-norm] worst readings: forward mean {worst['mean']:.2f}, "
        f"rstd {worst['rstd']:.2f}, y {worst['y.bfloat16']:.2f} f32 ulps "
        f"(limits "
        f"{LAYER_NORM_ULPS}); backward dx {worst['dx']:.3f}, dweight "
        f"{worst['dweight']:.3f}, dbias {worst['dbias']:.3f} of their limits")
    return dict(worst=worst, timing=timing)


def layer_norm_summary(kind, phase, serve, train, cli, families, multi,
                       graphs):
    """The kernels line's entry of the LayerNorm forward or backward: the
    launches of every path, counted on the card, phase 15's worst readings
    and its times at 16,000 rows in bf16 (and at each row count)."""
    name = "layer_norm" if kind == "forward" else "layer_norm_backward"
    paths = {"serve": serve[name], "train": train[name], "cli": cli[name],
             **{f: families[f][name] for f in FAMILIES},
             "dp": multi["dp"][name], "edge": multi["edge"][name],
             "edge_2x2": multi["edge_2x2"][name],
             "cli_dist": multi["cli"][name],
             "graphs_eval": graphs["eval_forward"][name],
             "graphs_train": graphs["train"][name]}
    if kind == "backward":
        del paths["serve"], paths["graphs_eval"]
    main = phase["timing"][(kind, 16000)]
    worst = phase["worst"]
    errs = (("mean", "rstd", "y.bfloat16") if kind == "forward"
            else ("dx", "dweight", "dbias"))
    return {"name": name, "route": "cuda",
            "source": "graphvqa_tpu_torch/csrc/layer_norm.cu",
            "replaces": "none: XLA's fusion of flax nn.LayerNorm "
                        "(graphvqa_tpu/nn/transformer.py:183)",
            "launches": train[name], "launches_by_path": paths,
            ("max_err_f32_ulps" if kind == "forward"
             else "max_err_share_of_limit"): {e: worst[e] for e in errs},
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "ms_by_rows": {r: phase["timing"][(kind, r)]["ms"]
                           for r in LN_ROWS}}


GINE_B, GINE_C, GINE_D = 200, 300, 512
# (h, edge_attr, ins) dtypes of the GINE phase: the bf16 model's rounds
# after the first, its first round (the scene encoder's float32 h), and the
# float32 configurations
GINE_DTYPES = {"bfloat16": ("bfloat16",) * 3,
               "first_round": ("float32", "bfloat16", "bfloat16"),
               "float32": ("float32",) * 3}


def gine_least_bytes(g, h, ins, edge_attr, backward):
    """The fewest bytes a GINE-pair call moves: the indices and mask read
    once; forward, every h row (z holds each row's own), the real edge
    rows and ins read, z written; backward, dz and ins read, the h rows
    that are some real edge's source and the real edge rows read, dh,
    every d_edge_attr row and d_ins written."""
    import torch
    real = g.edge_mask
    n_real = int(real.sum())
    N, C = h.shape
    B, D = ins.shape
    eh, ee, em = h.element_size(), edge_attr.element_size(), ins.element_size()
    idx = g.edges_pad * 9
    if not backward:
        return idx + N * C * eh + n_real * C * ee + B * D * em + N * (
            C + D) * em
    sources = int(torch.unique(g.edge_src[real]).numel())
    return (idx + N * (C + D) * em + sources * C * eh + n_real * C * ee
            + 2 * B * D * em + N * C * eh + g.edges_pad * C * ee)


def _gine_readings(got, want):
    """The worst error of each output against the plain version's: 0 for
    bit for bit; bf16 outputs as a share of 2^-7 of the tensor's largest
    |value| (two bf16 ulps: the f32 sums' order differs, then one rounding
    of the sum and one of z or dh), float32 ones as a share of TOL's."""
    import torch
    out = []
    for a, b in zip(got, want):
        diff = float((a.float() - b.float()).abs().max())
        if a.dtype == torch.bfloat16:
            lim = 2.0 ** -7 * float(b.float().abs().max())
        else:
            atol, rtol = TOL["float32"]
            lim = atol + rtol * float(b.float().abs().max())
        out.append(diff / lim)
    return out


def phase_gine(dev):
    """Phase 16: the GINE round's kernel pair against its plain versions
    (gine_messages_reference, gine_messages_backward_reference, run on the
    card) at the gine cell's shape in each of GINE_DTYPES: z's ins half
    and d_edge_attr bit for bit, the rest within _gine_readings' limits,
    two runs of each kernel bit for bit, one launch of each counted on the
    card a call; then each kernel's cold-L2 device time beside its
    least-bytes bound, the plain versions' and the composite's CUDA-event
    times (the composite: nn/gnn.py:GINESeq's concatenations, gather, ReLU
    and sum off the dense path, and autograd's backward through them)."""
    import torch
    from graphvqa_tpu_torch.core.packing import pack_graphs_dense
    from graphvqa_tpu_torch.nn.gnn import (
        gather_src, graph_to_edges, graph_to_nodes)
    from graphvqa_tpu_torch.ops import dense
    from graphvqa_tpu_torch.ops import gine_messages as gm
    from graphvqa_tpu_torch.ops.dispatch import aggregate_edge_values
    g = pack_graphs_dense(gqa_samples(GINE_B, seed=16), NPG, EPG).to(dev)
    dl, sl = dense.dense_local_indices(g)
    mask = g.edge_mask.reshape(dl.shape)
    C = GINE_C
    gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(
            getattr(torch, dtype))

    def composite(h, ins, edge_attr):
        x_cat = torch.cat([h, graph_to_nodes(g, ins)], dim=-1)
        edge_cat = torch.cat([edge_attr, graph_to_edges(g, ins)], dim=-1)
        msgs = torch.relu(gather_src(g, x_cat) + edge_cat)
        return x_cat + aggregate_edge_values(g, msgs)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    readings, timing = {}, {}
    for name, (th, te, ti) in GINE_DTYPES.items():
        h = randn(g.nodes_pad, C, dtype=th)
        edge_attr = randn(g.edges_pad, C, dtype=te)
        ins = randn(GINE_B, GINE_D, dtype=ti)
        ins = ins.to(gm.messages_dtype(h, ins, edge_attr))
        dz = randn(g.nodes_pad, C + GINE_D, dtype=str(ins.dtype)[6:])
        args = (h, ins, edge_attr, dl, sl, mask)
        f0 = launch_counts()
        z = gm.gine_messages(*args, npg=NPG)
        z_again = gm.gine_messages(*args, npg=NPG)
        grads = gm.gine_messages_backward(dz, *args, npg=NPG)
        grads_again = gm.gine_messages_backward(dz, *args, npg=NPG)
        torch.cuda.synchronize()
        since = launches_since(f0)
        counted = (since["gine_messages"], since["gine_messages_backward"])
        if counted != (2, 2):
            fail(f"gine {name}: two calls of each kernel counted {counted}")
        if not (torch.equal(z, z_again) and all(
                torch.equal(a, b) for a, b in zip(grads, grads_again))):
            fail(f"gine {name}: two runs differ")
        z_ref = gm.gine_messages_reference(*args, npg=NPG)
        grads_ref = gm.gine_messages_backward_reference(dz, *args, npg=NPG)
        if not torch.equal(z[:, C:], z_ref[:, C:]):
            fail(f"gine {name}: z's ins half is not the plain version's")
        if not torch.equal(grads[1], grads_ref[1]):
            fail(f"gine {name}: d_edge_attr is not the plain version's")
        read = dict(zip(("z", "dh", "d_ins"), _gine_readings(
            (z, grads[0], grads[2]), (z_ref, grads_ref[0], grads_ref[2]))))
        if max(read.values()) > 1.0:
            fail(f"gine {name}: errors {read} of their limits")
        readings[name] = read
        fwd = lambda: gm.gine_messages(*args, npg=NPG)  # noqa: E731
        bwd = lambda: gm.gine_messages_backward(  # noqa: E731
            dz, *args, npg=NPG)
        leaves = [t.clone().requires_grad_() for t in (h, ins, edge_attr)]
        z_comp = composite(*leaves)
        plain = dict(
            forward=cuda_median_ms(
                lambda: gm.gine_messages_reference(*args, npg=NPG)),
            backward=cuda_median_ms(
                lambda: gm.gine_messages_backward_reference(
                    dz, *args, npg=NPG)))
        with torch.no_grad():
            comp = dict(forward=cuda_median_ms(lambda: composite(
                h, ins, edge_attr)))
        comp["backward"] = cuda_median_ms(lambda: torch.autograd.grad(
            z_comp, leaves, dz, retain_graph=True))
        for kind, fn in (("forward", fwd), ("backward", bwd)):
            ms = call_ms(fn, flush)
            if ms is None:
                fail(f"torch.profiler recorded no gine {kind} call")
            nbytes = gine_least_bytes(g, h, ins, edge_attr,
                                      kind == "backward")
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            timing[(kind, name)] = dict(
                ms=ms, bound_ms=bound, plain_ms=plain[kind],
                composite_ms=comp[kind], bound_by="bytes")
            log(f"[gine] {kind:8s} {name}: device {ms * 1e3:.2f}us cold-L2 "
                f"({100 * bound / ms:.1f}% of bound {bound * 1e3:.2f}us, "
                f"{nbytes / 1e6:.2f} MB); wrapper host "
                f"{host_us_per_call(fn):.2f}us/call; plain "
                f"{plain[kind] * 1e3:.1f}us, composite "
                f"{comp[kind] * 1e3:.1f}us (events)")
        log(f"[gine] {name}: {int(g.edge_mask.sum())} real edges of "
            f"{g.edges_pad}; errors z {read['z']:.3f}, dh {read['dh']:.3f}, "
            f"d_ins {read['d_ins']:.3f} of their limits, the ins half and "
            f"d_edge_attr bit for bit, two runs bit for bit")
    return dict(readings=readings, timing=timing)


def gine_summary(kind, phase, families):
    """The kernels line's entry of the GINE forward or backward: its
    launches in phase 12's gine steps (3 requests and 3 train steps),
    phase 16's worst readings and its bf16 time."""
    name = "gine_messages" + ("" if kind == "forward" else "_backward")
    main = phase["timing"][(kind, "bfloat16")]
    return {"name": name, "route": "cuda",
            "source": f"graphvqa_tpu_torch/csrc/{name}.cu",
            "replaces": "none: the JAX package's GINESeq is XLA ops "
                        "(graphvqa_tpu/nn/gnn.py:439)",
            "launches": families["gine"][name],
            "max_err_share_of_limit": {
                n: max(r.values()) for n, r in phase["readings"].items()},
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "composite_ms": main["composite_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "ms_by_dtypes": {n: phase["timing"][(kind, n)]["ms"]
                             for n in GINE_DTYPES}}


# --- phase 17: LCGN's node-wise float32 linears --------------------------------

LCGN_B = 200
# (in, out, bias) of LCGN's node-wise linears and how many run a forward at
# lcgn_iters 4: init_sg_emb_input; proj_x_loc and proj_x_ctx; lin_l / lin_r
# / cal_x stacked; output_layer and fin_layer
LCGN_LINEARS = {(300, 512, True): 1, (512, 512, True): 5,
                (1536, 1536, False): 4, (1024, 512, True): 5}
LCGN_NPG = (64, 128)


def lcgn_bound_ms(real, N, K, Nout, bias, backward):
    """(least ms, bound by): the real rows' multiply-adds at the float32
    peak, or the bytes at 3.35 TB/s, whichever is larger. Bytes: the row
    list read; forward x's real rows, W and b read once, every y row
    written (the padding rows' zeros are part of the result); backward
    dy's and x's real rows and W read once, every dx row, dW and db
    written."""
    flops = 2 * real * K * Nout * (2 if backward else 1)
    rows = 4 * N + 4
    if backward:
        nbytes = rows + 4 * (real * (Nout + K) + Nout * K + N * K
                             + Nout * K + Nout * bias)
    else:
        nbytes = rows + 4 * (real * K + Nout * K + Nout * bias + N * Nout)
    t_flops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_flops, t_bytes) * 1e3,
            "flops" if t_flops >= t_bytes else "bytes")


def phase_lcgn(dev):
    """Phase 17: LCGN's linear pair (ops/lcgn_linear.py) at the lcgn cell's
    shapes (B=200 at npg 64 and 128, every (in, out) of LCGN_LINEARS) on
    masks drawn from the traffic's scene law: the row list against its
    plain twin; forward and backward against the plain versions on the
    card within the float32 round-off bound (2 n 2^-24 of the sum of the
    terms' magnitudes), the padding rows 0, two runs bit for bit, one
    launch of each counted on the card; then each kernel's device time
    (cold L2) beside its bound, the plain versions' time (CUDA events) and
    F.linear's over every padded row (cold L2; backward: autograd's dx and
    dW through it); the share of rows computed, and the sums over one
    train step's linears at npg 64."""
    import torch
    from graphvqa_tpu_torch.ops import lcgn_linear as ll
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    from torch_port_fixtures import round_off_share, scene_law_mask
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    timing, worst, shares = {}, {}, {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def within(got, want, n, scale, what):
        share = round_off_share(got, want, n, scale)
        if share > 1.0:
            fail(f"lcgn {what}: {share:.3f} of its round-off bound")
        worst[what.split()[0]] = max(worst.get(what.split()[0], 0.0), share)

    for npg in LCGN_NPG:
        mask = scene_law_mask(LCGN_B, npg, seed=npg).to(dev)
        N = mask.shape[0]
        f0 = launch_counts()
        rows = ll.node_rows(mask)
        perm, count = ll.node_rows_reference(mask)
        torch.cuda.synchronize()
        if launches_since(f0)["lcgn_rows"] != 1:
            fail("lcgn: the row list did not count its launch")
        if not (torch.equal(rows.perm, perm) and torch.equal(rows.count,
                                                            count)):
            fail(f"lcgn: the row list at npg {npg} is not its plain twin's")
        real = int(count)
        shares[npg] = real / N
        m = mask[:, None]
        for (K, Nout, bias), _ in LCGN_LINEARS.items():
            x, w = randn(N, K), randn(Nout, K) / K ** 0.5
            b = randn(Nout) if bias else None
            dy = randn(N, Nout)
            f0 = launch_counts()
            y = ll.lcgn_linear(x, w, b, rows)
            grads = ll.lcgn_linear_backward(dy, x, w, rows.perm, rows.count,
                                            has_bias=bias)
            y2 = ll.lcgn_linear(x, w, b, rows)
            grads2 = ll.lcgn_linear_backward(dy, x, w, rows.perm, rows.count,
                                             has_bias=bias)
            torch.cuda.synchronize()
            since = launches_since(f0)
            if (since["lcgn_linear"], since["lcgn_linear_backward"]) != (2, 2):
                fail(f"lcgn {K}->{Nout}: two calls of each kernel counted "
                     f"{since}")
            if not (torch.equal(y, y2) and all(
                    (a is None and c is None) or torch.equal(a, c)
                    for a, c in zip(grads, grads2))):
                fail(f"lcgn {K}->{Nout}: two runs differ")
            dx, dw, db = grads
            if y[~mask].any() or dx[~mask].any():
                fail(f"lcgn {K}->{Nout}: a padding row is not 0")
            ref = ll.lcgn_linear_backward_reference(dy, x, w, mask,
                                                    has_bias=bias)
            ax, aw = torch.where(m, x, 0.0).abs(), w.abs()
            ady = torch.where(m, dy, 0.0).abs()
            within(y, ll.lcgn_linear_reference(x, w, b, mask), K + 1,
                   ax @ aw.t() + (b.abs() if bias else 0.0),
                   f"y {K}->{Nout}")
            within(dx, ref[0], Nout, ady @ aw, f"dx {K}->{Nout}")
            within(dw, ref[1], real, ady.t() @ ax, f"dw {K}->{Nout}")
            if bias:
                within(db, ref[2], real, ady.sum(0), f"db {K}->{Nout}")
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            y_lib = torch.nn.functional.linear(xr, wr, b)
            fns = {
                "forward": (lambda: ll.lcgn_linear(x, w, b, rows),
                            lambda: ll.lcgn_linear_reference(x, w, b, mask),
                            lambda: torch.nn.functional.linear(x, w, b)),
                "backward": (lambda: ll.lcgn_linear_backward(
                                 dy, x, w, rows.perm, rows.count,
                                 has_bias=bias),
                             lambda: ll.lcgn_linear_backward_reference(
                                 dy, x, w, mask, has_bias=bias),
                             lambda: torch.autograd.grad(
                                 y_lib, (xr, wr), dy, retain_graph=True))}
            for kind, (fn, plain, lib) in fns.items():
                ms, lib_ms = call_ms(fn, flush), call_ms(lib, flush)
                if ms is None or lib_ms is None:
                    fail(f"torch.profiler recorded no lcgn {kind} call")
                bound, by = lcgn_bound_ms(real, N, K, Nout, bias,
                                          kind == "backward")
                timing[(kind, npg, K, Nout)] = dict(
                    ms=ms, bound_ms=bound, bound_by=by,
                    plain_ms=cuda_median_ms(plain), library_ms=lib_ms)
                t = timing[(kind, npg, K, Nout)]
                log(f"[lcgn] {kind:8s} npg {npg} {K:4d}->{Nout}: device "
                    f"{ms * 1e3:.2f}us cold-L2 ({100 * bound / ms:.1f}% of "
                    f"bound {bound * 1e3:.2f}us, {by}); plain "
                    f"{t['plain_ms'] * 1e3:.1f}us (events); F.linear every "
                    f"row {lib_ms * 1e3:.2f}us cold-L2; wrapper host "
                    f"{host_us_per_call(fn):.2f}us/call")
        log(f"[lcgn] npg {npg}: {real} real rows of {N} "
            f"({100 * shares[npg]:.1f}% of the rows computed)")
    for npg in LCGN_NPG:
        sums = {(kind, key): sum(n * timing[(kind, npg, K, Nout)][key]
                                 for (K, Nout, _), n in LCGN_LINEARS.items())
                for kind in ("forward", "backward")
                for key in ("ms", "library_ms", "bound_ms")}
        log(f"[lcgn] one train step's linears at npg {npg} (cold L2, summed "
            f"over {sum(LCGN_LINEARS.values())} linears): kernels "
            f"{sums[('forward', 'ms')]:.3f} + {sums[('backward', 'ms')]:.3f}"
            f" ms, bound {sums[('forward', 'bound_ms')]:.3f} + "
            f"{sums[('backward', 'bound_ms')]:.3f} ms, F.linear every row "
            f"{sums[('forward', 'library_ms')]:.3f} + "
            f"{sums[('backward', 'library_ms')]:.3f} ms")
    log(f"[lcgn] worst errors as shares of their round-off bounds: "
        f"{', '.join(f'{k} {v:.4f}' for k, v in worst.items())}; two runs "
        f"bit for bit; padding rows 0")
    return dict(timing=timing, worst=worst, shares=shares)


def lcgn_summary(kind, phase, families):
    """The kernels line's entry of the LCGN forward or backward: its
    launches in phase 12's lcgn steps (3 requests and 3 train steps),
    phase 17's worst readings, its times at npg 64 for 1,024 -> 512 (and
    every shape) and the share of rows computed."""
    name = "lcgn_linear" + ("" if kind == "forward" else "_backward")
    main = phase["timing"][(kind, 64, 1024, 512)]
    return {"name": name, "route": "cuda",
            "source": f"graphvqa_tpu_torch/csrc/{name}.cu",
            "replaces": "none: the JAX package's LCGN linears are XLA dots "
                        "over every padded row (graphvqa_tpu/nn/gnn.py)",
            "launches": families["lcgn"][name],
            "launches_by_path": {f: families[f][name] for f in FAMILIES},
            "max_err_share_of_round_off_bound": phase["worst"],
            "rows_computed_share": phase["shares"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "ms_by_shape": {f"npg {npg} {K}->{n}": t["ms"]
                            for (k, npg, K, n), t in phase["timing"].items()
                            if k == kind}}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    try:
        from graphvqa_tpu_torch.config import gat_config
        from graphvqa_tpu_torch.ops import cuda_lib
    except ImportError as exc:
        fail(f"the graphvqa_tpu_torch package is not importable: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    clock = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        log(f"[seconds] phase {phase}: {now - clock[0]:.1f}s")
        clock[0] = now

    built = cuda_lib.kernel_libraries()
    log(f"[build] nvcc {built.build_seconds:.1f}s (in parallel) -> "
        f"{', '.join(str(p) for p in built.paths.values())}")
    for line in built.log.strip().splitlines():
        if any(w in line for w in ("registers", "spill", "error", "smem")):
            log(f"[build] {line.strip()}")
    done("1 build")
    kernel = phase_kernel(dev)
    done("2 kernel")
    backward = phase_backward(dev)
    done("3 backward")
    cfg = gat_config()
    model = full_model(cfg, dev)
    log(f"[model] gat_config() params "
        f"{sum(p.numel() for p in model.parameters())} dtype {cfg.model.dtype}")
    phase_parity(cfg, dev, model)
    done("4 parity")
    serve, step, request = phase_serve(cfg, dev, model)
    done("5 serve")
    phase_profile(model, step, request)
    done("6 profile")
    train = phase_train(cfg, dev, model)
    done("7 train")
    del model, step, request
    phase_train_parity(dev)
    done("8 train-parity")
    data = phase_data(cfg)
    done("9 data")
    ladder = phase_ladder(dev, data)
    done("10 ladder")
    cli = phase_cli(cfg, dev, data)
    done("11 cli")
    families = phase_families(dev, data)
    done("12 families")
    multi = phase_multi(dev, data)
    done("13 multi")
    graphs = phase_graphs(dev, data)
    done("14 graphs")
    layer_norm = phase_layer_norm(dev)
    done("15 layer-norm")
    gine = phase_gine(dev)
    done("16 gine")
    lcgn = phase_lcgn(dev)
    done("17 lcgn")

    card = card_line()
    fwd = kernel[("bfloat16", "graph", True)]
    bwd = backward[("bfloat16", "graph", True)]
    summary = {"kernels": [{
        "name": "gat_round", "route": "cuda",
        "source": "graphvqa_tpu_torch/csrc/gat_round.cu",
        "replaces": "graphvqa_tpu/ops/pallas/fused_dense_gat.py:44",
        "launches": train["gat_round"],
        "launches_by_path": {"serve": serve["gat_round"],
                             "train": train["gat_round"],
                             "cli": cli["forward"],
                             "onlysg": families["onlysg"]["forward"],
                             "exec": families["exec"]["forward"],
                             "dp": multi["dp"]["gat_round"],
                             "edge": multi["edge"]["gat_round"],
                             "edge_2x2": multi["edge_2x2"]["gat_round"],
                             "graphs_eval":
                                 graphs["eval_forward"]["gat_round"],
                             "graphs_train": graphs["train"]["gat_round"]},
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "ladder_max_abs_err": ladder["forward"],
        "shard_max_abs_err": max(r["forward_err"]
                                 for r in multi["kernels"].values()),
        "shard_ms": {f"K={k} {n}": r["forward_ms"]
                     for (k, n), r in multi["kernels"].items()},
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": None}, {
        "name": "gat_round_backward", "route": "cuda",
        "source": "graphvqa_tpu_torch/csrc/gat_round_backward.cu",
        "replaces": "none: XLA autodiff of "
                    "graphvqa_tpu/ops/dense.py:350 dense_gat_aggregate",
        "launches": train["gat_round_backward"],
        "launches_by_path": {"train": train["gat_round_backward"],
                             "cli": cli["backward"],
                             "onlysg": families["onlysg"]["backward"],
                             "exec": families["exec"]["backward"],
                             "dp": multi["dp"]["gat_round_backward"],
                             "edge": multi["edge"]["gat_round_backward"],
                             "edge_2x2":
                                 multi["edge_2x2"]["gat_round_backward"],
                             "graphs_train":
                                 graphs["train"]["gat_round_backward"]},
        "max_abs_err": max(r["max_abs_err"] for r in backward.values()),
        "ladder_max_abs_err": ladder["backward"],
        "shard_max_abs_err": max(r["backward_err"]
                                 for r in multi["kernels"].values()),
        "shard_ms": {f"K={k} {n}": r["backward_ms"]
                     for (k, n), r in multi["kernels"].items()},
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": None}] + [layer_norm_summary(
            kind, layer_norm, serve, train, cli, families, multi, graphs)
            for kind in ("forward", "backward")] + [
            gine_summary(kind, gine, families)
            for kind in ("forward", "backward")] + [
            lcgn_summary(kind, lcgn, families)
            for kind in ("forward", "backward")]}
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
