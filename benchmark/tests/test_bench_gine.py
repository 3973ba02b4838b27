"""The GINE cell's check at a tiny width on the CPU, as
``test_bench_check.py`` holds the gat and lcgn cells: the plain reference
(``engines/gine.py``) against the port's train steps in float32, the
control and the faults turning ``correct`` false under the cell's limits,
and the engine's operation count against one done by hand."""
import numpy as np
import torch

import engines
from counts.flops import batch_flops, forward_flops
from harness import cell, check, control
from test_bench_check import HalfBatch, Unchanged, run

CELL = "gine.train.gqa_b200"
CPU = torch.device("cpu")


def test_the_reference_follows_the_ports_gine_train_steps(tiny):
    """float32 on both sides: the same losses, first gradients and
    changes to round-off, the rounds' dropout and the program loss
    included."""
    res = run(CELL, tiny)
    c = res["readings"]
    assert c["loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-4 and c["grad_dist"] < 1e-4
    assert c["change_gap_median"] < 1e-4
    assert res["correct"]


def test_the_gine_control_and_half_batch_are_not_correct(tiny):
    """The reference in float8 in the program's place, and the mean over
    half of each batch, each fail a limit of the cell."""
    r = control.train_readings(CELL, 7, CPU, overrides=tiny)
    for case in ("control_fp8", "fault_half_batch"):
        ok, _ = check.judge(r[case], check.limits(CELL))
        assert not ok, case


def test_half_of_the_batch_left_out_is_caught_on_gine(tiny, monkeypatch):
    assert not run(CELL, tiny, hooks=HalfBatch(monkeypatch))["correct"]


def test_a_gine_step_that_leaves_the_state_unchanged_is_caught(tiny):
    assert not run(CELL, tiny, hooks=Unchanged())["correct"]


def test_the_gine_operation_count_is_the_hand_count():
    """Five rounds of MLP(812 -> 300 -> 300) on the 57 real nodes of a
    fixed batch, and the rest of the model counted as for gat."""
    cfg = cell.config_file("gine")["model"]
    gat = cell.config_file("gat")["model"]
    n, e, q = (np.asarray(v, np.float64) for v in ([17, 40], [60, 200],
                                                   [10, 13]))
    by_hand = 5 * 57 * (2 * 812 * 300 + 2 * 300 * 300)
    ops, width = engines.load("gine").flops(cfg, n, e, q)
    assert (ops, width) == (by_hand, 300)
    batch = ([10, 13], [[4] * 5, [6] * 5], [17, 40], [60, 200])
    gat_ops = engines.load("gat").flops(gat, n, e, q)[0]
    assert forward_flops(cfg, *batch, greedy=False) == \
        forward_flops(gat, *batch, greedy=False) - gat_ops + by_hand
    counts = dict(zip(("q_tokens", "prog_positions", "nodes", "edges"),
                      batch))
    assert batch_flops(cfg, counts, True) == \
        3 * forward_flops(cfg, *batch, greedy=False)
