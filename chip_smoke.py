#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphvqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build    nvcc builds csrc/gat_round.cu for sm_90a (first use)
  2. kernel   the GAT-round kernel against its plain PyTorch version at the
              main path's shapes (B=512, npg=64, epg=256, H=4, C=300) on
              GQA-shaped random graphs: both softmax shifts, with and without
              the instruction share, f32 and bf16; max error; the kernel's
              device time (torch.profiler, median, cold L2) beside the
              least-bytes bound, the wrapper's host time per call, and the
              plain version's time (CUDA events, median)
  3. parity   the full-width gat_config() model (random seeded weights,
              random BatchNorm statistics, bf16) on B=8, card against CPU
  4. serve    make_eval_step on 3 requests of B=512 at full width; the kernel
              must run exactly 5 times per request; ms per step and QA/s
  5. profile  where one more request's time goes: stage times on the host
              clock, the device's busy share and its heaviest kernels

The last two lines are the card's name and power limit (nvidia-smi) and a
{"kernels": [...]} summary before the final {"ok": true, "device": ...}.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
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


def device_median_ms(fn, kernel_name, flush, reps=20):
    """Median device duration of the ``kernel_name`` kernels that ``reps``
    calls of ``fn`` launch, from torch.profiler's CUDA events. ``flush`` (a
    tensor larger than the 50 MB L2) is zeroed before each call, so every
    call starts from a cold L2; the flush kernels are not counted. None when
    the profiler recorded no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == DeviceType.CUDA and kernel_name in ev.name]
    return statistics.median(us) / 1e3 if us else None


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


def least_bytes(inp, elem, with_ins):
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
            + n_edges * H * f32 + 3 * B * EPG * f32
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


def phase_parity(cfg, dev, model_gpu):
    import torch
    batch = qa_batch(cfg, 8, seed=11)
    model_cpu = full_model(cfg, "cpu")
    t0 = time.perf_counter()
    out_gpu = model_gpu.sample(batch.to(dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_cpu = model_cpu.sample(batch.to("cpu"))
    t2 = time.perf_counter()
    g = out_gpu.short_answer_logits.float().cpu()
    c = out_cpu.short_answer_logits.float()
    if g.shape != (8, cfg.model.num_answers) or not torch.isfinite(g).all():
        fail(f"card logits: shape {tuple(g.shape)} or non-finite values")
    err = float((g - c).abs().max())
    same = g.argmax(-1) == c.argmax(-1)
    top2 = c.topk(2, dim=-1).values
    close = (top2[:, 0] - top2[:, 1]) <= PARITY_ATOL    # a near tie on the CPU
    tok = float((out_gpu.program_tokens.cpu() == out_cpu.program_tokens)
                .float().mean())
    log(f"[parity] B=8 bf16 full width: max |logit card - cpu| = {err:.4f} "
        f"(limit {PARITY_ATOL}), |logit| max {float(c.abs().max()):.3f}, "
        f"argmax equal on {int(same.sum())}/8 rows ({int((~same).sum())} "
        f"differ, {int(close.sum())} near ties), program tokens agree "
        f"{tok:.3f}; card {t1 - t0:.2f}s cpu {t2 - t1:.2f}s")
    if err > PARITY_ATOL or bool((~same & ~close).any()):
        fail("card and CPU disagree on the eval path")
    del model_cpu


def phase_serve(cfg, dev, model):
    import torch
    from graphvqa_tpu_torch.ops.gat_round import gat_round
    from graphvqa_tpu_torch.train.loop import make_eval_step
    step = make_eval_step(model, cfg)
    requests = [qa_batch(cfg, B, seed=100 + i).to(dev) for i in range(4)]
    step(requests[0])                                  # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gat_round.launches = 0
    times, outs = [], []
    for req in requests[1:]:
        t0 = time.perf_counter()
        out = step(req)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = gat_round.launches
    rounds = cfg.model.engine.num_rounds
    if launches != rounds * len(times):
        fail(f"gat_round launched {launches} times on the main path, "
             f"expected {rounds} x {len(times)}")
    V = cfg.model.text.vocab_size
    for vectors, tokens, attention in outs:
        if not (torch.isfinite(vectors["sa_score"]).all()
                and torch.isfinite(attention).all()):
            fail("non-finite eval outputs")
        if tokens.shape != (B * cfg.model.max_execution_steps,
                            cfg.model.program_decode_len):
            fail(f"program tokens shape {tuple(tokens.shape)}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= V:
            fail("program tokens out of the vocabulary")
        if vectors["sa_pred"].shape != (B,) or attention.shape != (B * NPG,):
            fail("eval vector shapes")
    ms = [t * 1e3 for t in times]
    log(f"[serve] {len(times)} requests of B={B}: ms/step "
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(request)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    if not kernels:
        log("[profile] the profiler recorded no device time: not measured")
        return
    busy_us = sum(ev.time_range.elapsed_us() for ev in kernels)
    by_name = {}
    for ev in kernels:
        n, t = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, t + ev.time_range.elapsed_us())
    log(f"[profile] one step: wall {wall_us / 1e3:.2f} ms (profiled), "
        f"{len(kernels)} device kernels, device busy {busy_us / 1e3:.2f} ms "
        f"= {100 * busy_us / wall_us:.1f}% of wall")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"[profile]   {t / 1e3:8.3f} ms {n:6d}x  {name[:90]}")


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

    lib = gr.load_library()
    log(f"[build] nvcc {lib.build_seconds:.1f}s -> {lib.path}")
    for line in lib.log.strip().splitlines():
        if any(w in line for w in ("registers", "spill", "error", "smem")):
            log(f"[build] {line.strip()}")
    kernel = phase_kernel(dev)
    cfg = gat_config()
    model = full_model(cfg, dev)
    log(f"[model] gat_config() params "
        f"{sum(p.numel() for p in model.parameters())} dtype {cfg.model.dtype}")
    phase_parity(cfg, dev, model)
    launches, step, request = phase_serve(cfg, dev, model)
    phase_profile(model, step, request)

    card = card_line()
    main_cfg = kernel[("bfloat16", "graph", True)]
    summary = {"kernels": [{
        "name": "gat_round", "route": "cuda",
        "source": "graphvqa_tpu_torch/csrc/gat_round.cu",
        "replaces": "graphvqa_tpu/ops/pallas/fused_dense_gat.py:44",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "ms": main_cfg["ms"], "plain_ms": main_cfg["plain_ms"],
        "bound_ms": main_cfg["bound_ms"], "bound_by": main_cfg["bound_by"],
        "library_ms": None}]}
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
