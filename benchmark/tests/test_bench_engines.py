"""The engines in files of their own (``engines/<kind>.py``) change no
number: for gat and lcgn at the tests' tiny size on a fixed seed, the
initialisation rules and weights, the reference's three train losses, its
first gradients and changes, its served short-answer logits and
teacher-forced program and full-answer logits, the operation counts and the
GAT kernels' least bytes equal, bit for bit, what the code had given with
the engines inside the reference, the count and the weights
(``engines_before_the_move.json``, recorded at one thread).

The counts are integer and float64 arithmetic on the host and hold on any
build. The weights and the reference's readings are float32 arithmetic
whose last bits depend on the CPU kernels PyTorch picks, so they are held
on the build they were recorded on (its version and CPU capability are in
the file) and skip on another.
"""
import functools
import hashlib
import json

import pytest
import torch

import engines
from counts.flops import forward_flops
from harness import cell, check, common, main, train_cell, weights
from harness.traffic import load_traffic
from reference import inputs as ref_inputs
from reference.model import SOS, Reference

GOLDEN = json.loads((cell.ROOT / "tests" / "engines_before_the_move.json")
                    .read_text())
SEED = GOLDEN["seed"]
CPU = torch.device("cpu")
ARITHMETIC = ("rules", "weights", "losses", "grads", "changes", "served")
COUNTS = ("forward_flops", "forward_flops_greedy", "flops", "host_flops",
          "kernel_bytes")


def digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for n, t in tensors.items():
        t = t.detach().contiguous().cpu()
        h.update(f"{n}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:24]


def build() -> dict:
    return dict(torch=torch.__version__,
                cpu=torch.backends.cpu.get_cpu_capability())


def readings(name: str, shrink) -> dict:
    """Every number held, for configuration ``name``, at one thread."""
    from graphvqa_tpu_torch.models.pipeline import PipelineModel
    cfg_file, traffic = shrink(cell.config_file(name),
                               load_traffic("gqa_train_b200"))
    cfg = cell.port_config(cfg_file, traffic)
    kind = cfg_file["model"]["engine"]["kind"]
    s = common.prepare(cfg, cfg_file, traffic, SEED)
    try:
        with torch.device("meta"):
            shapes = common.leaf_shapes(PipelineModel(cfg.model))
        engine = engines.load(kind)
        out = {"rules": hashlib.sha256(repr([
            weights._rule(n, sh, shapes, engine) for n, sh in shapes.items()
        ]).encode()).hexdigest()[:24]}
        out["weights"] = digest(weights.make_weights(shapes, SEED, CPU, kind))
        plans = train_cell.plan_steps(s, SEED, 1.0)
        steps = [[p[k] for p in plans] for k in range(train_cell.CHECK_STEPS)]
        ref = check.reference_train(s, shapes, steps, SEED, CPU)
        out["losses"] = ref["losses"]
        out["grads"] = digest(ref["grads"])
        out["changes"] = digest(ref["changes"])
        # served logits over the first batch, teacher-forced over tokens
        # drawn from the seed
        B, M = cfg.batch.num_graphs, cfg.model.max_execution_steps
        (npg, epg), idx = plans[0][0]
        b = ref_inputs.to_device(s.reader.batch(idx, npg, epg, B), CPU)
        g = torch.Generator().manual_seed(SEED)
        prog = torch.randint(4, 100, (B * M, 16), generator=g)
        fa = torch.randint(4, 100, (B, 20), generator=g)
        prog[:, 0] = fa[:, 0] = SOS
        r = Reference(common.reference_params(shapes, SEED + 1, CPU, kind),
                      cfg_file["model"])
        sa, pl, fl = r.served_logits(b, prog, fa,
                                     torch.Generator().manual_seed(SEED + 2))
        out["served"] = digest({"sa": sa, "program": pl, "full_answer": fl})
        # the counts: a fixed batch at the configuration's full widths, and
        # the window's counts over the plan's first batches
        full = cell.config_file(name)["model"]
        batch = ([10, 13], [[4] * 5, [6] * 5], [17, 40], [60, 200])
        out["forward_flops"] = forward_flops(full, *batch, greedy=False)
        out["forward_flops_greedy"] = forward_flops(full, *batch,
                                                    greedy=True)
        metas = [{"question_ids": list(map(int, i)), "real_count": len(i)}
                 for _, i in plans[0][:4]]
        win = common.Window(mode="train", metas=metas, steps=4,
                            host_steps=3, trace_metas=metas[:2])
        main.fill_counts(win, s, SEED)
        out.update(flops=win.flops, host_flops=win.host_flops,
                   kernel_bytes=list(win.gat_bytes))
        return out
    finally:
        common.cleanup(s)


@functools.lru_cache(maxsize=None)
def cached(name: str, shrink) -> str:
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return json.dumps(readings(name, shrink))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["gat", "lcgn"])
def test_the_counts_are_those_before_the_move(name, tiny):
    got = json.loads(cached(name, tiny))
    for k in COUNTS:
        assert got[k] == GOLDEN[name][k], k


@pytest.mark.parametrize("name", ["gat", "lcgn"])
def test_the_weights_and_the_reference_are_those_before_the_move(name,
                                                                 tiny):
    if build() != GOLDEN["build"]:
        pytest.skip(f"float32 readings recorded on {GOLDEN['build']}, "
                    f"this is {build()}")
    got = json.loads(cached(name, tiny))
    for k in ARITHMETIC:
        assert got[k] == GOLDEN[name][k], k
