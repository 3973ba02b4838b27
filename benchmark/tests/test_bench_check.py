"""The check that decides ``correct``, at a tiny width on the CPU: the
plain reference against the port, the control coming out not correct, and
each fault a cell can have, planted under a whole run, turning ``correct``
false. One card test runs a cell on the card."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from harness import cell, check, control, main

CPU = torch.device("cpu")


def run(workload, tiny, seed=5, hooks=None, dtype="float32"):
    return main.result(workload, seed, 1.0, False, CPU, time.perf_counter(),
                       hooks=hooks,
                       overrides=lambda c, t: tiny(c, t, dtype))


@pytest.mark.parametrize("workload", ["gat.train.gqa_b200",
                                      "lcgn.train.gqa_b200"])
def test_the_reference_follows_the_ports_train_steps(workload, tiny):
    """float32 on both sides: the same losses, first gradients and
    changes to round-off, dropout and LCGN's draws included."""
    res = run(workload, tiny)
    c = res["readings"]
    assert c["loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-4
    assert c["change_gap"] < 1e-2 and c["change_gap_median"] < 1e-4
    assert res["correct"]


def test_the_reference_scores_the_ports_greedy_answers(tiny):
    res = run("gat.eval.gqa_b200", tiny)
    for k in ("answer_logit_dist", "answer_served_gap", "answer_gap",
              "program_gap", "full_answer_gap"):
        assert res["readings"][k] < 1e-4, k
    assert res["correct"]


def test_the_train_control_is_not_correct(tiny):
    """The reference in float8 in the program's place fails a limit."""
    r = control.train_readings("gat.train.gqa_b200", 7, CPU,
                               overrides=tiny)
    ok, _ = check.judge(r["control_fp8"],
                        check.limits("gat.train.gqa_b200"))
    assert not ok
    ok, _ = check.judge(r["fault_half_batch"],
                        check.limits("gat.train.gqa_b200"))
    assert not ok


def test_the_eval_control_is_not_correct(tiny):
    r = control.eval_readings("gat.eval.gqa_b200", 7, 1.0, CPU,
                              overrides=tiny)
    ok, _ = check.judge(r["control_fp8"], check.limits("gat.eval.gqa_b200"))
    assert not ok


class Unchanged:
    """A train step that hands its state back unchanged."""

    def train_step(self, step):
        def unchanged(state, batch, gen, ctx=None):
            keep = {n: p.detach().clone()
                    for n, p in state.model.named_parameters()}
            moments = {k: {n: t.clone() for n, t in state.opt_state[k].items()}
                       for k in ("mu", "nu")}
            state, m = step(state, batch, gen, ctx)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(keep[n])
                for k in ("mu", "nu"):
                    for n, t in state.opt_state[k].items():
                        t.copy_(moments[k][n])
            return state, m
        unchanged.graphs = getattr(step, "graphs", None)
        return unchanged


class HalfBatch:
    """The loss's mean over the first half of each batch."""

    def __init__(self, monkeypatch):
        from graphvqa_tpu_torch.train import loop
        original = loop.total_loss

        def half(out, *args, **kw):
            import dataclasses
            n = out.short_answer_logits.shape[0] // 2
            out = dataclasses.replace(
                out, short_answer_logits=out.short_answer_logits[:n])
            args = list(args)
            args[2] = args[2][:n]           # the short-answer labels
            return original(out, *args, **kw)
        monkeypatch.setattr(loop, "total_loss", half)

    def train_step(self, step):
        return step


class AlteredToken:
    """The first program token, or the short answer, of each request
    altered where the eval step produces it."""

    def __init__(self, what: str):
        self.what = what

    def eval_step(self, step):
        def altered(batch, generator=None):
            vec, prog, att = step(batch, generator)
            if self.what == "program":
                prog = prog.clone()
                prog[:, 1] = (prog[:, 1] + 17) % 2000 + 4
            else:
                vec = dict(vec, sa_pred=(vec["sa_pred"] + 5) % 1842)
            return vec, prog, att
        altered.graphs = getattr(step, "graphs", None)
        return altered


class WrongEngine:
    """The engine's node features in validation in the wrong rows, as a
    GAT kernel that aggregates into the wrong destinations leaves them."""

    def __init__(self, monkeypatch):
        from graphvqa_tpu_torch.models.pipeline import PipelineModel
        original = PipelineModel._engine

        def wrong(self, *args, **kw):
            x, att = original(self, *args, **kw)
            return x.flip(0), att
        monkeypatch.setattr(PipelineModel, "_engine", wrong)

    def eval_step(self, step):
        return step


class NoExchange:
    """The data-parallel step's all-reduce left out, on every rank."""

    def train_step(self, step):
        from graphvqa_tpu_torch.parallel.data_parallel import StepReduce
        StepReduce.all_reduce = lambda self: None
        return step


def with_dp_cell() -> dict:
    """The manifest, with the data-parallel cell's entry should it lack
    one (its traffic and limits files are the benchmark's either way)."""
    man = cell.manifest()
    if not any(w["traffic"] == "gqa_train_dp4_b200" for w in man["workloads"]):
        man["workloads"].append({"name": "gat.train.dp4_gqa_b200",
                                 "config": "gat", "chips": 4,
                                 "traffic": "gqa_train_dp4_b200", "why": "-"})
    return man


def two_ranks(tiny):
    def over(c, t):
        c, t = tiny(c, t)
        t.update(ranks=2, questions=320, scenes=32, workers=1)
        return c, t
    return over


def test_the_reference_follows_the_data_parallel_step(tiny):
    """Two gloo ranks on the CPU: the reference means both ranks'
    gradients, each drawn with its own rank's dropout."""
    res = main.result("gat.train.dp4_gqa_b200", 5, 1.0, False, CPU,
                      time.perf_counter(), man=with_dp_cell(),
                      overrides=two_ranks(tiny))
    assert res["readings"]["grad_gap"] < 1e-4
    assert res["readings"]["grad_dist_median"] < 1e-4
    assert res["correct"]


def test_the_exchange_between_ranks_left_out_is_caught(tiny, monkeypatch):
    from graphvqa_tpu_torch.parallel.data_parallel import StepReduce
    # restored at teardown: the hook patches this process's class too
    monkeypatch.setattr(StepReduce, "all_reduce", StepReduce.all_reduce)
    res = main.result("gat.train.dp4_gqa_b200", 5, 1.0, False, CPU,
                      time.perf_counter(), hooks=NoExchange(),
                      man=with_dp_cell(), overrides=two_ranks(tiny))
    assert not res["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny):
    assert not run("gat.train.gqa_b200", tiny, hooks=Unchanged())["correct"]


def test_half_of_the_batch_left_out_is_caught(tiny, monkeypatch):
    res = run("gat.train.gqa_b200", tiny, hooks=HalfBatch(monkeypatch))
    assert not res["correct"]


@pytest.mark.parametrize("what", ["program", "answer"])
def test_an_altered_token_is_caught(tiny, what):
    res = run("gat.eval.gqa_b200", tiny, hooks=AlteredToken(what))
    assert not res["correct"], res["checks"]


def test_a_wrong_engine_in_validation_is_caught(tiny, monkeypatch):
    res = run("gat.eval.gqa_b200", tiny, hooks=WrongEngine(monkeypatch))
    assert res["checks"]["answer_logit_dist"]["value"] > \
        res["checks"]["answer_logit_dist"]["limit"]
    assert not res["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gat.train.gqa_b200",
                                      "gat.eval.gqa_b200"])
def test_a_cell_on_the_card(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(cell.ROOT / "run.py"), "--workload", workload,
         "--seed", "2147483911", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=cell.CHECKOUT,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
