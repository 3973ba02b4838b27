"""The GCN cell's check at a tiny width on the CPU, as ``test_bench_gine.py``
holds the gine cell: the plain reference (``engines/gcn.py``) against the
port's train steps in float32, the control and the faults turning
``correct`` false under the cell's limits, the engine's operation count
against one done by hand; and the in-process traffic mix against the one
it copies."""
import numpy as np
import pytest
import torch

import engines
from counts.flops import batch_flops, forward_flops
from harness import cell, check, control
from harness.traffic import load_traffic
from test_bench_check import HalfBatch, Unchanged, run

CELL = "gcn.train.gqa_b200"
CPU = torch.device("cpu")


def test_the_reference_follows_the_ports_gcn_train_steps(tiny):
    """float32 on both sides: the same losses, first gradients and
    changes to round-off, the rounds' dropout and the program loss
    included."""
    res = run(CELL, tiny)
    c = res["readings"]
    assert c["loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-4 and c["grad_dist"] < 1e-4
    assert c["change_gap_median"] < 1e-4
    assert res["correct"]


def test_the_gcn_control_and_half_batch_are_not_correct(tiny):
    """The reference in float8 in the program's place, and the mean over
    half of each batch, each fail a limit of the cell."""
    r = control.train_readings(CELL, 7, CPU, overrides=tiny)
    for case in ("control_fp8", "fault_half_batch"):
        ok, _ = check.judge(r[case], check.limits(CELL))
        assert not ok, case


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_a_faulty_gcn_step_is_caught(fault, tiny, monkeypatch):
    hooks = HalfBatch(monkeypatch) if fault == "half_batch" else Unchanged()
    assert not run(CELL, tiny, hooks=hooks)["correct"]


def test_the_gcn_operation_count_is_the_hand_count():
    """Five rounds of the 812 -> 300 projection on the 57 real nodes and
    of the 300-wide weighted sum over the 260 real edges of a fixed batch,
    and the rest of the model counted as for gat."""
    cfg = cell.config_file("gcn")["model"]
    gat = cell.config_file("gat")["model"]
    n, e, q = (np.asarray(v, np.float64) for v in ([17, 40], [60, 200],
                                                   [10, 13]))
    by_hand = 5 * (57 * 2 * 812 * 300 + 260 * 2 * 300)
    ops, width = engines.load("gcn").flops(cfg, n, e, q)
    assert (ops, width) == (by_hand, 300)
    batch = ([10, 13], [[4] * 5, [6] * 5], [17, 40], [60, 200])
    gat_ops = engines.load("gat").flops(gat, n, e, q)[0]
    assert forward_flops(cfg, *batch, greedy=False) == \
        forward_flops(gat, *batch, greedy=False) - gat_ops + by_hand
    counts = dict(zip(("q_tokens", "prog_positions", "nodes", "edges"),
                      batch))
    assert batch_flops(cfg, counts, True) == \
        3 * forward_flops(cfg, *batch, greedy=False)


def test_the_inproc_mix_is_the_train_mix_collated_in_process():
    """``gqa_train_b200_inproc`` differs from ``gqa_train_b200`` in
    ``workers`` alone: 0, the training CLI's default."""
    inproc = load_traffic("gqa_train_b200_inproc")
    base = load_traffic("gqa_train_b200")
    assert {k for k in base.keys() | inproc.keys()
            if base.get(k) != inproc.get(k)} == {"name", "workers"}
    assert (base["workers"], inproc["workers"]) == (2, 0)
