#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphvqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build    nvcc builds csrc/gat_round.cu and csrc/gat_round_backward.cu
              for sm_90a (first use, one nvcc per source, in parallel)
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
  5. serve    make_eval_step on 3 requests of B=512 at full width; the kernel
              must run exactly 5 times per request; ms per step and QA/s
  6. profile  where one more request's time goes: stage times on the host
              clock, the device's busy share and its heaviest kernels
  7. train    make_train_step at full width on B=512: 1 warm-up and 5
              counted steps; both kernels must run exactly 5 times per step;
              ms per step, QA/s, the loss of each step, then one profiled
              step: device busy share and heaviest kernels
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
              counted (5 forward per eval step, 5 + 5 per train step); then
              one batch forced into the flat layout through the eval step,
              card against CPU, and a train step on the card
 12. families the other model families at full width: gcn_config(),
              gine_config(), lcgn_config(), onlysg_config() and gat_config()
              with the execution engine (and its bitmap loss). Each: card
              against CPU on B=8 in bf16 (logits, and the bitmap, as phase
              4 holds them) and in one f32 train step (phase 8's limits);
              make_eval_step on 1 warm-up + 3 requests and make_train_step
              on 1 warm-up + 3 steps at B=512 (ms per step, QA/s, each
              step's loss, peak memory, one profiled step's busy share and
              heaviest five kernels); the GAT kernels must run 5 (eval) and
              5 + 5 (train) times per step on onlysg and exec, never on gcn,
              gine and lcgn. LCGN's context features come from a seeded
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
              then bf16 steps (ms per step per rank, GAT launches 5 + 5 per
              rank per step). (c) the edge-sharded step, B=512 at data 1 x
              edge 2: one f32 step against the single-process step (phase
              8's limits, with the ReLU pins), bf16 steps with the epg_loc
              reached; then one step at data 2 x edge 2 on 4 ranks. (d) the
              CLI under torchrun: one rank on nccl (an epoch, validation,
              --resume --evaluate with the dumps) and --data-parallel 2 on
              two ranks over gloo, whose gathered dump holds every val
              question once. (e) convert_ckpt_cli on a reference-format
              checkpoint of the seeded full-width model, restored logits
              equal, --resume --evaluate on the card. Several ranks on one
              card measure the port's overheads, not scaling

Each phase's seconds print as "[seconds] phase N".

The last two lines are the card's name and power limit (nvidia-smi) and a
{"kernels": [...]} summary before the final {"ok": true, "device": ...}.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

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


def qa_batch(cfg, num_graphs, seed):
    """A synthetic request: GQA-shaped graphs and random token streams with
    config.BatchConfig's lengths (question 32, program 16, answer 20)."""
    import numpy as np
    import torch
    from graphvqa_tpu_torch.core.graph import QABatch
    from graphvqa_tpu_torch.core.packing import pack_graphs_dense
    bc, mc = cfg.batch, cfg.model
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


def least_bytes(inp, elem, with_ins, epg=EPG):
    """The fewest bytes one GAT round must move on this batch: each input
    element that the result depends on read once, the output written once.
    That is the xw and alpha_l rows of distinct real sources, the alpha_r
    rows of distinct real destinations, the alpha_e rows of real edges,
    dl/sl/mask in full, ins in full when passed, and out in full. Padded
    node rows of xw are never read, so they do not count."""
    import torch
    dl, sl, mask = inp["dl"].long(), inp["sl"].long(), inp["mask"]
    real = (mask > 0) & (dl >= 0) & (dl < NPG) & (sl >= 0) & (sl < NPG)
    base = torch.arange(B, device=dl.device)[:, None] * NPG
    n_src = int(torch.unique((sl + base)[real]).numel())
    n_dst = int(torch.unique((dl + base)[real]).numel())
    n_edges = int(real.sum())
    f32 = 4
    return (n_src * H * C * elem + n_src * H * f32 + n_dst * H * f32
            + n_edges * H * f32 + 3 * B * epg * f32
            + (B * H * C * elem if with_ins else 0) + B * NPG * C * elem)


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
    """The fewest bytes one GAT-round backward must move on this batch:
    the forward's inputs that the gradients depend on read once (indices and
    mask in full, the xw and alpha_l rows of distinct real sources, the
    alpha_r rows and upstream-gradient rows of distinct real destinations,
    the alpha_e and dropout-scale rows of real edges, ins in full), and
    every gradient written once in full (d_xw, d_alpha_l/r, d_alpha_e,
    d_ins)."""
    import torch
    dl, sl, mask = inp["dl"].long(), inp["sl"].long(), inp["mask"]
    real = (mask > 0) & (dl >= 0) & (dl < NPG) & (sl >= 0) & (sl < NPG)
    base = torch.arange(B, device=dl.device)[:, None] * NPG
    n_src = int(torch.unique((sl + base)[real]).numel())
    n_dst = int(torch.unique((dl + base)[real]).numel())
    n_edges = int(real.sum())
    f32 = 4
    reads = (3 * B * epg * f32 + n_src * H * C * elem + n_src * H * f32
             + n_dst * H * f32 + n_dst * C * elem
             + n_edges * H * f32 * (2 if with_keep else 1) + B * H * C * elem)
    writes = (B * NPG * H * C * elem + 2 * B * NPG * H * f32
              + B * epg * H * f32 + B * H * C * elem)
    return reads + writes, n_edges, n_dst


def phase_backward(dev):
    import torch
    from graphvqa_tpu_torch.ops.gat_round import (
        gat_round_backward, gat_round_backward_reference)
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
        again = gat_round_backward(*call_args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"gat_round_backward {name} shift={shift}: two runs differ")
        units = int(gat_round_backward.counter)
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


def gat_rounds(cfg):
    """GAT-kernel launches per step (forward, or backward) of a config:
    one per round on the gat engines (gat, and onlysg's "none"), none on
    gcn, gine and lcgn."""
    e = cfg.model.engine
    return e.num_rounds if e.kind in ("gat", "none") else 0


def phase_serve(cfg, dev, model, tag="serve", ctx=None):
    """make_eval_step on 1 warm-up and 3 counted B=512 requests (counts set
    to 0 just before them and read just after); ``ctx`` is LCGN's
    generator."""
    import torch
    from graphvqa_tpu_torch.ops.gat_round import gat_round
    from graphvqa_tpu_torch.train.loop import make_eval_step
    step = make_eval_step(model, cfg)
    requests = [qa_batch(cfg, B, seed=100 + i).to(dev) for i in range(4)]
    step(requests[0], ctx)                             # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gat_round.launches = 0
    times, outs = [], []
    for req in requests[1:]:
        t0 = time.perf_counter()
        out = step(req, ctx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = gat_round.launches
    if launches != gat_rounds(cfg) * len(times):
        fail(f"{tag}: gat_round launched {launches} times in {len(times)} "
             f"requests, expected {gat_rounds(cfg)} per request")
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
    log(f"[{tag}] {len(times)} requests of B={B}: ms/step "
        f"{', '.join(f'{m:.2f}' for m in ms)} (mean {statistics.mean(ms):.2f}),"
        f" QA/s {B / statistics.mean(times):.1f}, gat_round launches "
        f"{launches}, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
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
    busy share and its ``top`` heaviest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return
    busy_us = sum(ev.time_range.elapsed_us() for ev in kernels)
    by_name = {}
    for ev in kernels:
        n, t = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, t + ev.time_range.elapsed_us())
    log(f"[{tag}] one profiled step: wall {wall_us / 1e3:.2f} ms, "
        f"{len(kernels)} device kernels, device busy {busy_us / 1e3:.2f} ms "
        f"= {100 * busy_us / wall_us:.1f}% of wall")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[{tag}]   {t / 1e3:8.3f} ms {n:6d}x  {name[:90]}")


def phase_train(cfg, dev, model, steps=5, tag="train", ctx=None, top=12):
    """The full-width train step on B=512: 1 warm-up and ``steps`` counted
    steps (counts set to 0 just before them and read just after), then one
    profiled step. ``ctx`` is LCGN's generator."""
    import torch
    from graphvqa_tpu_torch.ops.gat_round import gat_round, gat_round_backward
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    tc = cfg.train
    state = create_train_state(model, lr=tc.lr, lr_drop=tc.lr_drop,
                               lr_gamma=tc.lr_gamma,
                               weight_decay=tc.weight_decay)
    step = make_train_step(model, cfg)
    batch = qa_batch(cfg, B, seed=200).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    step(state, batch, gen, ctx)                        # warm-up step
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    gat_round.launches = gat_round_backward.launches = 0
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen, ctx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["total"]))
    fwd, bwd = gat_round.launches, gat_round_backward.launches
    rounds = gat_rounds(cfg)
    if (fwd, bwd) != (rounds * len(times), rounds * len(times)):
        fail(f"{tag}: gat_round {fwd} and gat_round_backward {bwd} launches "
             f"in {len(times)} steps, expected {rounds} each per step")
    if not all(map(math.isfinite, losses)):
        fail(f"{tag}: non-finite training loss: {losses}")
    parts = ", ".join(f"{k} {float(v):.5f}" for k, v in m.items()
                      if k in ("short_answer", "program", "execution_bitmap"))
    ms = [t * 1e3 for t in times]
    log(f"[{tag}] {len(times)} steps of B={B} at full width (dropout "
        f"{cfg.model.transformer.dropout}/{cfg.model.engine.dropout}/"
        f"{cfg.model.classifier_dropout}, lr {tc.lr}): ms/step "
        f"{', '.join(f'{v:.2f}' for v in ms)} (mean {statistics.mean(ms):.2f}"
        f", warm-up {warm * 1e3:.0f}), QA/s {B / statistics.mean(times):.1f}"
        f"; loss per step {', '.join(f'{v:.5f}' for v in losses)} (last: "
        f"{parts}); launches per step gat_round {fwd // len(times)}, "
        f"gat_round_backward {bwd // len(times)}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    profiled_step(lambda: step(state, batch, gen, ctx), tag, top)
    return fwd, bwd


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
    f_tr, b_tr = (int(v) for v in _last_match(
        r"kernel launches \(train epoch 0\): gat_round (\d+), "
        r"gat_round_backward (\d+)", train_out, "train launches"))
    kernel_steps = steps - layouts["flat_fallback"]
    if (f_tr, b_tr) != (rounds * kernel_steps, rounds * kernel_steps):
        fail(f"CLI epoch: gat_round {f_tr} / gat_round_backward {b_tr} "
             f"launches for {kernel_steps} dense steps, expected {rounds} "
             f"each per step")
    val_q = int(_last_match(r"eval sustained: [\d.]+ qa/s \((\d+) questions",
                            train_out, "validation summary"))
    f_val = int(_last_match(r"kernel launches \(validate epoch 0\): "
                            r"gat_round (\d+)", train_out,
                            "validate launches"))
    if f_val != rounds * -(-val_q // B):
        fail(f"CLI validation: {f_val} gat_round launches for {val_q} "
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
    f_ev = int(_last_match(r"kernel launches \(evaluate val_balanced\): "
                           r"gat_round (\d+)", eval_out, "evaluate launches"))
    if f_ev != rounds * -(-eval_q // B):
        fail(f"CLI evaluate: {f_ev} gat_round launches for {eval_q} "
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
        f"data-wait {wait:.1f}%, layouts {layouts}, launches gat_round "
        f"{f_tr} gat_round_backward {b_tr}; validation {val_q} questions, "
        f"gat_round {f_val}; process {train_s:.1f}s")
    log(f"[cli] --resume --evaluate: {eval_q} questions at {eval_qa_s:.1f} "
        f"QA/s, gat_round {f_ev} launches, dumps {len(dump)} results / "
        f"{len(atts)} attention rows; process {eval_s:.1f}s; scorer "
        f"{accuracy}, {grounding}")
    phase_flat(cfg, dev, data)
    log(f"[cli] phase {time.perf_counter() - t_phase:.1f}s")
    return dict(forward=f_tr + f_val + f_ev, backward=b_tr)


def phase_flat(cfg, dev, data):
    """One batch forced into the flat layout (B=8 of the val split with the
    dense padding at 2 nodes / 8 edges, beyond the ladder): the eval step
    card against CPU as phase 4 holds it, and a train step on the card."""
    import dataclasses
    import torch
    from graphvqa_tpu_torch.data import GQADataset, build_scene_graph_vocab
    from graphvqa_tpu_torch.data.vocab import Vocab
    from graphvqa_tpu_torch.ops.gat_round import gat_round, gat_round_backward
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
        f0 = gat_round.launches
        vectors, tokens, attention = make_eval_step(model, fcfg)(
            batch.to(device))
        outs[str(device)] = model.sample(batch.to(device)).short_answer_logits \
            .float().cpu()
        if device != "cpu":
            if gat_round.launches != f0:
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
        f"{loss:.5f}; no kernel launched (the flat round is plain ops)")


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
        serve, _, _ = phase_serve(cfg, dev, model, tag=tag, ctx=ctx)
        fwd, bwd = phase_train(cfg, dev, model, steps=3, tag=tag, ctx=ctx,
                               top=5)
        launches[name] = dict(forward=serve + fwd, backward=bwd)
        log(f"[{tag}] gat_round launches: serve {serve} (3 requests), train "
            f"{fwd} + backward {bwd} (3 steps); {time.perf_counter() - t0:.1f}s")
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
    f_tr, b_tr = (int(v) for v in _last_match(
        r"kernel launches \(train epoch 0\): gat_round (\d+), "
        r"gat_round_backward (\d+)", stdout, "train launches"))
    if (f_tr, b_tr) != (0, 0):
        fail(f"lcgn CLI: the GAT kernels launched {f_tr} / {b_tr} times")
    res = _last_match(r"val_balanced (\{.*'bitmap_recall'.*\})", stdout,
                      "validation result with the bitmap meters")
    qa_s = _last_match(r"epoch sustained: ([\d.]+) qa/s", stdout,
                       "epoch summary")
    if not (out / "ckpt" / "ckpt_0.pt").exists():
        fail("lcgn CLI: no checkpoint")
    log(f"[families cli] lcgn + execution engine, B={B}: losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}, epoch {qa_s} QA/s, "
        f"validation {res}, GAT launches 0 / 0; process {secs:.1f}s, phase "
        f"{time.perf_counter() - t0:.1f}s")


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


def _rank_main(rank, world, cases):
    """A spawned rank: gloo on the one card, the cases in order."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{MULTI_DIR}/store{world}", rank=rank,
        world_size=world)
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
    step = make_dp_edge_train_step(model, cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(data_seed(0, mesh))
    torch.use_deterministic_algorithms(True, warn_only=True)
    _, m = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    rec = step_record(model, state, m)
    rec.update(pins=pins, epg_loc=batch.graphs.edges_per_graph)
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


def _rank_time(rank, case):
    """bf16 train steps at full width on this rank's batch: 1 warm-up and
    ``steps`` counted ones, the GAT launches counted over them."""
    import torch
    from graphvqa_tpu_torch.ops.gat_round import gat_round, gat_round_backward
    from graphvqa_tpu_torch.parallel.data_parallel import reduce_gradients
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_dp_edge_train_step, prepare_dp_edge_batch)
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
    step = make_dp_edge_train_step(model, cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(data_seed(0, mesh))
    if case["warmup"]:
        step(state, batch, gen)
    torch.cuda.synchronize()
    gat_round.launches = gat_round_backward.launches = 0
    times, losses = [], []
    for _ in range(case["steps"]):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["total"]))
    launches = gat_round.launches, gat_round_backward.launches
    # the step's one gradient all-reduce alone (it also averages the
    # running statistics, so the model is not used after this)
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_gradients(model, mesh)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    torch.save(dict(times=times, losses=losses, launches=launches,
                    epg_loc=batch.graphs.edges_per_graph,
                    reduce_ms=statistics.median(reduce_ms),
                    peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30),
               MULTI_DIR / f"{case['name']}_rank{rank}.pt")


RANK_CASES = {"check": _rank_check, "time": _rank_time}


def run_ranks(world, cases):
    """``cases`` on ``world`` spawned gloo ranks sharing the card; each
    rank's saved results by case name."""
    import torch
    import torch.multiprocessing as mp
    (MULTI_DIR / f"store{world}").unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(_rank_main, args=(world, cases), nprocs=world,
                       join=True, start_method="spawn")
    out = {c["name"]: [torch.load(MULTI_DIR / f"{c['name']}_rank{r}.pt",
                                  weights_only=False) for r in range(world)]
           for c in cases}
    log(f"[multi] {world} ranks over gloo on one card: "
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


def _timing_line(tag, runs, rounds):
    """Per-rank ms per step and launches of a 'time' case; fails on a
    non-finite loss or launches other than ``rounds`` + ``rounds`` per
    rank per step."""
    parts = []
    total = [0, 0]
    for r, run in enumerate(runs):
        steps = len(run["times"])
        if run["launches"] != (rounds * steps, rounds * steps):
            fail(f"{tag} rank {r}: gat_round / gat_round_backward launches "
                 f"{run['launches']} in {steps} steps, expected {rounds} "
                 f"each per step")
        if not all(map(math.isfinite, run["losses"])):
            fail(f"{tag} rank {r}: non-finite loss {run['losses']}")
        total[0] += run["launches"][0]
        total[1] += run["launches"][1]
        parts.append(f"rank {r}: ms/step "
                     f"{', '.join(f'{t * 1e3:.2f}' for t in run['times'])}, "
                     f"loss {', '.join(f'{v:.5f}' for v in run['losses'])}, "
                     f"epg_loc {run['epg_loc']}, the gradient all-reduce "
                     f"alone {run['reduce_ms']:.1f} ms, peak "
                     f"{run['peak_gib']:.2f} GiB")
    log(f"[{tag}] " + "; ".join(parts) + f"; launches per rank per step "
        f"{rounds} + {rounds}")
    return total


def phase_dp(dev):
    """13b: the data-parallel step, gat_config() at full width, two ranks
    of B=256 on the card. One float32 step: each rank's own gradient equals
    the single-process step on its batch, and the updated parameters the
    average-then-Adam of those two steps (phase 8's limits, and 1e-6 of each
    tensor's scale where |gradient| > 1e-5); the running statistics their
    mean. Then bf16 steps (1 warm-up, 3 counted) for ms per step per rank
    and the GAT launches."""
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
             batch=Bd, seed=300),
        dict(kind="time", name="dp_time", data=2, edge=1, cfg=cfg, batch=Bd,
             seed=310, warmup=True, steps=3)])
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
    launches = _timing_line(f"multi dp bf16 B={Bd} per rank",
                            ranks["dp_time"], gat_rounds(cfg))
    log(f"[multi dp] phase {time.perf_counter() - t0:.1f}s")
    return launches


def phase_edge(dev):
    """13c: the edge-sharded step, gat_config() at full width, B=512 at data
    1 x edge 2. One float32 step against the single-process step on the
    card, held as phase 8 holds the card against the CPU (the ranks' ReLU
    inputs whose sign differs at round-off set to the single process's);
    the two ranks' gradient shares sum to its gradient. Then bf16 steps (1
    warm-up, 3 counted): the epg_loc reached, ms per step, GAT launches;
    then one data 2 x edge 2 step on 4 ranks (B=256 per data rank).
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
             batch=B, seed=400, relu_ref=str(relu_ref)),
        dict(kind="time", name="edge_time", data=1, edge=2, cfg=cfg, batch=B,
             seed=410, warmup=True, steps=3)])
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
    launches = _timing_line(f"multi edge bf16 B={B} data 1 x edge 2",
                            ranks["edge_time"], rounds)
    grid = run_ranks(4, [dict(kind="time", name="edge_2x2", data=2, edge=2,
                              cfg=cfg, batch=B // 2, seed=420, warmup=False,
                              steps=1)])
    more = _timing_line(f"multi edge bf16 data 2 x edge 2, B={B // 2} per "
                        f"data rank, first step", grid["edge_2x2"], rounds)
    log(f"[multi edge] phase {time.perf_counter() - t0:.1f}s")
    return launches, more


def _run_torchrun(nproc, args, name, timeout=600):
    """The port's train CLI under torchrun (--standalone) with ``nproc``
    ranks; output to build/chip_smoke/<name>.log."""
    return _run_cli(["torch.distributed.run", "--standalone",
                     "--nproc_per_node", str(nproc), "-m",
                     "graphvqa_tpu_torch.cli.train_cli"] + args, name,
                    timeout)


def phase_cli_dist(data):
    """13d: the CLI under torchrun on phase 9's val split (1,024
    questions): one rank on nccl (an epoch of 2 steps of B=512 with a
    validation, then --resume --evaluate with the dumps), and
    --data-parallel 2 with two ranks sharing the card over gloo (an epoch of
    2 steps of B=256 per rank, then --evaluate over both ranks' shards,
    whose gathered dump must hold every val question once)."""
    t0 = time.perf_counter()
    root = data["data"]
    launches = [0, 0]
    for tag, nproc, bsz, extra in (
            ("nccl", 1, B, []),
            ("gloo-dp2", 2, B // 2, ["--data-parallel", "2",
                                     "--dist-backend", "gloo"])):
        out = SMOKE_DIR / f"cli_{tag}"
        common = ["--data-root", str(root), "--split", "val_balanced",
                  "--val-split", "val_balanced", "--batch-size", str(bsz),
                  "--print-freq", "1", "--output_dir", str(out)] + extra
        train_out, train_s = _run_torchrun(nproc, common + [
            "--epochs", "1", "--validate-every", "1", "--fast-validate", "1"],
            f"cli_{tag}_train")
        f_tr, b_tr = (int(v) for v in _last_match(
            r"kernel launches \(train epoch 0\): gat_round (\d+), "
            r"gat_round_backward (\d+)", train_out, "train launches"))
        losses = [float(v) for v in re.findall(r"Loss (\S+) \(", train_out)]
        if not losses or not all(map(math.isfinite, losses)):
            fail(f"CLI {tag}: training losses {losses}")
        if not (out / "ckpt" / "ckpt_0.pt").exists():
            fail(f"CLI {tag}: no checkpoint")
        eval_out, eval_s = _run_torchrun(nproc, common + [
            "--resume", str(out / "ckpt"), "--evaluate", "--dump-result",
            "--dump-attentions", "--fast-validate", str(1024 // (bsz * nproc))
        ], f"cli_{tag}_evaluate")
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
        launches[0] += f_tr
        launches[1] += b_tr
        log(f"[multi cli {tag}] torchrun --nproc_per_node {nproc}, B={bsz} "
            f"per rank: train losses {', '.join(f'{v:.5f}' for v in losses)},"
            f" rank 0's launches gat_round {f_tr} gat_round_backward {b_tr}; "
            f"evaluate: {len(dump)} results and {len(atts)} attention rows "
            f"gathered, each val question once, {res}; processes "
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
        from graphvqa_tpu_torch.ops import gat_round as gr
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

    lib = gr.load_library()
    log(f"[build] nvcc {lib.build_seconds:.1f}s (in parallel) -> "
        f"{', '.join(str(p) for p in lib.paths.values())}")
    for line in lib.log.strip().splitlines():
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
    serve_launches, step, request = phase_serve(cfg, dev, model)
    done("5 serve")
    phase_profile(model, step, request)
    done("6 profile")
    train_fwd, train_bwd = phase_train(cfg, dev, model)
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

    card = card_line()
    fwd = kernel[("bfloat16", "graph", True)]
    bwd = backward[("bfloat16", "graph", True)]
    summary = {"kernels": [{
        "name": "gat_round", "route": "cuda",
        "source": "graphvqa_tpu_torch/csrc/gat_round.cu",
        "replaces": "graphvqa_tpu/ops/pallas/fused_dense_gat.py:44",
        "launches": train_fwd,
        "launches_by_path": {"serve": serve_launches, "train": train_fwd,
                             "cli": cli["forward"],
                             "onlysg": families["onlysg"]["forward"],
                             "exec": families["exec"]["forward"],
                             "dp": multi["dp"][0], "edge": multi["edge"][0],
                             "edge_2x2": multi["edge_2x2"][0]},
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
        "launches": train_bwd,
        "launches_by_path": {"train": train_bwd, "cli": cli["backward"],
                             "onlysg": families["onlysg"]["backward"],
                             "exec": families["exec"]["backward"],
                             "dp": multi["dp"][1], "edge": multi["edge"][1],
                             "edge_2x2": multi["edge_2x2"][1]},
        "max_abs_err": max(r["max_abs_err"] for r in backward.values()),
        "ladder_max_abs_err": ladder["backward"],
        "shard_max_abs_err": max(r["backward_err"]
                                 for r in multi["kernels"].values()),
        "shard_ms": {f"K={k} {n}": r["backward_ms"]
                     for (k, n), r in multi["kernels"].items()},
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": None}]}
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
