"""The comparison that decides ``correct``: what the timed path produced,
held to the plain reference (``reference/model.py``) on the same inputs.

Training: the reference follows the train step's first three steps (the
same weights, batches, dropout and context draws, Adam) and reads:
  * ``loss_gap``: the largest relative gap between the two losses of a step;
  * ``grad_gap``: over leaves, the gap between the norms of the first
    gradient (the program's worked out from Adam's first moment after one
    step), over the larger of the reference leaf's norm and the median
    leaf's; ``grad_gap_median``: the median leaf's such gap;
  * ``grad_dist`` and ``grad_dist_median``: the norm of the difference of
    the two first gradients, over the same denominator, worst and median
    leaf (compared where the gaps of norms cannot tell a lower precision
    from the configuration's, ``PERF.md``);
  * ``change_gap`` and ``change_gap_median``: the same for the norm of each
    leaf's change after the three steps, leaving out the elements whose
    reference gradient is under a thousandth of the median leaf's root mean
    square (they move by round-off under Adam: a key's bias under softmax,
    a third of each attention's fused input bias).
A cell's limits file names the ones it compares (``PERF.md`` says why).
Validation, over two batches of the window:
  * ``answer_logit_dist``: over the served rows, the largest distance
    between the program's short-answer logits and the reference's, over
    the norm of the reference's row (the scene-graph and question encoders,
    the engine with its kernels, pooling and the classifier);
  * ``answer_served_gap``: the widest gap by which a served short answer's
    logit lies below the best of the logits it was served from;
  * the widest gap by which a served answer's logit lies below the
    reference's best, teacher-forced over the served tokens:
    ``answer_gap`` (short answers), ``program_gap`` (greedy program
    tokens) and ``full_answer_gap`` (greedy full-answer tokens).

The limits are data, one file per cell: ``benchmark/limits/<cell>.json``.
"""
from __future__ import annotations

import json
import math
import pathlib

import numpy as np
import torch

from harness import common
from reference import inputs as ref_inputs
from reference.model import Reference, adam_step, set_exact_float32

LIMITS = pathlib.Path(__file__).resolve().parents[1] / "limits"
NEGLIGIBLE_GRAD = 1e-3      # of the median leaf's first-gradient RMS


def limits(workload: str) -> dict:
    return json.loads((LIMITS / f"{workload}.json").read_text())


def reference_train(s, shapes: dict, steps, seed: int, device,
                    precision: str = "f32", fault=None) -> dict:
    """The reference's three steps: losses, first gradients and their norms,
    and each leaf's change. ``steps`` holds, per step, each data rank's
    (rung, rows); the ranks' gradients and losses are meaned, each rank
    drawing from generators seeded as the run seeds its own. ``fault``
    plants a fault in the reference put in the program's place
    (``"half_batch"``: the mean over half of each batch; ``"no_exchange"``:
    rank 0's own gradient and loss, the ranks' exchange left out)."""
    from harness.train_cell import rank_seed
    set_exact_float32()
    cfg = s.cfg
    params = common.reference_params(shapes, seed + 1, device,
                                     s.cfg.model.engine.kind)
    start = {n: params[n].clone() for n in shapes}
    for n in shapes:
        params[n].requires_grad_(True)
    ref = Reference(params, s.cfg_dict["model"], precision)
    if fault == "no_exchange":
        steps = [per_rank[:1] for per_rank in steps]
    n_ranks = len(steps[0])
    gens = [(torch.Generator(device=device).manual_seed(rank_seed(seed + 3, r)),
             torch.Generator(device=device).manual_seed(rank_seed(seed + 2, r)))
            for r in range(n_ranks)]
    mu = {n: torch.zeros_like(params[n]) for n in shapes}
    nu = {n: torch.zeros_like(params[n]) for n in shapes}
    leaves = {n: params[n] for n in shapes}
    losses, grad_norms = [], None
    for k, per_rank in enumerate(steps):
        grads, loss_sum = {}, 0.0
        for r, ((npg, epg), idx) in enumerate(per_rank):
            b = ref_inputs.to_device(
                s.reader.batch(idx, npg, epg, cfg.batch.num_graphs), device)
            if fault == "half_batch":
                b = dict(b, rows=cfg.batch.num_graphs // 2)
            loss = ref.train_loss(b, gens[r][0], gens[r][1],
                                  cfg.train.use_program_loss)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            for n, g in zip(leaves, got):
                if g is not None:
                    g = g / n_ranks
                    grads[n] = g if n not in grads else grads[n] + g
            loss_sum += float(loss.detach())
        if k == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(grads[n]))
                          if n in grads else 0.0 for n in leaves}
            first = {n: grads[n].detach().clone() if n in grads
                     else torch.zeros_like(params[n]) for n in leaves}
        losses.append(loss_sum / n_ranks)
        adam_step(leaves, grads, mu, nu, k + 1, cfg.train.lr)
    change = {n: params[n].detach() - start[n] for n in shapes}
    return dict(losses=losses, grad_norms=grad_norms, changes=change,
                grads=first)


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf: the gap of the two norms over the larger of the reference
    leaf's norm and the median leaf's."""
    med = float(np.median([ref[n] for n in ref]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref}


def change_norms(prog: dict, ref: dict) -> tuple:
    """(the program's, the reference's) norm of each leaf's change over
    the elements whose reference gradient is not negligible; a leaf with
    none is left out."""
    norms = ref["grad_norms"]
    rms = float(np.median([norms[n] / math.sqrt(max(g.numel(), 1))
                           for n, g in ref["grads"].items()]))
    got, want = {}, {}
    for n, g in ref["grads"].items():
        keep = g.abs() >= NEGLIGIBLE_GRAD * rms
        if not bool(keep.any()):
            continue
        want[n] = float(torch.linalg.vector_norm(ref["changes"][n][keep]))
        got[n] = float(torch.linalg.vector_norm(
            prog["changes"][n].to(g.device)[keep]))
    return got, want


def train_numbers(prog: dict, ref: dict, detail: dict = None) -> dict:
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                        ref["losses"]))
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    med_g = float(np.median(list(ref["grad_norms"].values())))
    dist = {n: float(torch.linalg.vector_norm(
        prog["grads"][n].to(g.device) - g)) / max(ref["grad_norms"][n], med_g,
                                                  1e-30)
        for n, g in ref["grads"].items()}
    change = leaf_gaps(*change_norms(prog, ref))
    if detail is not None:
        for name, gaps in (("grad", grad), ("change", change),
                           ("grad_dist", dist)):
            detail[name] = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    return dict(loss_gap=loss_gap, grad_gap=max(grad.values()),
                grad_gap_median=float(np.median(list(grad.values()))),
                grad_dist=max(dist.values()),
                grad_dist_median=float(np.median(list(dist.values()))),
                change_gap=max(change.values()),
                change_gap_median=float(np.median(list(change.values()))))


def program_train_numbers(check: dict) -> dict:
    """The program's readings as floats (read after the window)."""
    return dict(losses=[float(x) for x in check["losses"]],
                grad_norms={n: float(v) for n, v in check["grad_norms"].items()},
                changes=check["changes"],
                grads=check["grads"])


def _gap(logits: torch.Tensor, served: torch.Tensor, banned=()) -> float:
    """Widest gap of the served tokens' logits below the best one."""
    lg = logits.float().clone()
    for t in banned:
        lg[..., t] = float("-inf")
    best = lg.amax(-1)
    got = lg.gather(-1, served.long()[..., None])[..., 0]
    return float((best - got).max())


def eval_numbers(s, shapes: dict, check: dict, seed: int, device,
                 precision: str = "f32") -> dict:
    """The widest gaps over the checked batches' served answers."""
    set_exact_float32()
    params = common.reference_params(shapes, seed + 1, device,
                                     s.cfg.model.engine.kind)
    ref = Reference(params, s.cfg_dict["model"], "f32")
    low = Reference(params, s.cfg_dict["model"], precision)
    out = dict(answer_logit_dist=0.0, answer_served_gap=0.0, answer_gap=0.0,
               program_gap=0.0, full_answer_gap=0.0)
    B = s.cfg.batch.num_graphs
    for idx, (npg, epg), answers in zip(check["rows"], check["rungs"],
                                        check["outputs"]):
        if answers is None:
            raise RuntimeError("a checked batch was not served in the window")
        b = ref_inputs.to_device(s.reader.batch(idx, npg, epg, B), device)
        prog = torch.as_tensor(answers["program_tokens"], device=device)
        fa = torch.as_tensor(answers["full_answer_tokens"], device=device)
        sa_ref, prog_ref, fa_ref = ref.served_logits(b, prog, fa, None)
        if precision == "f32":
            sa = torch.as_tensor(answers["sa_pred"], device=device)
            sa_logits = torch.as_tensor(answers["sa_logits"], device=device)
        else:
            # the control: what the lower precision puts first
            sa_low, prog_low, fa_low = low.served_logits(b, prog, fa, None)
            sa, sa_logits = sa_low.argmax(-1), sa_low
            prog = torch.cat([prog[:, :1], _greedy(prog_low)], 1)
            fa = torch.cat([fa[:, :1], _greedy(fa_low)], 1)
        real = len(idx)
        out["answer_logit_dist"] = max(out["answer_logit_dist"], _row_dist(
            sa_logits[:real], sa_ref[:real]))
        out["answer_served_gap"] = max(out["answer_served_gap"],
                                       _gap(sa_logits[:real], sa[:real]))
        out["answer_gap"] = max(out["answer_gap"],
                                _gap(sa_ref[:real], sa[:real]))
        M = s.cfg.model.max_execution_steps
        banned = (ref_inputs.PAD, ref_inputs.SOS)
        out["program_gap"] = max(out["program_gap"], _gap(
            prog_ref[:real * M], prog[:real * M, 1:], banned))
        out["full_answer_gap"] = max(out["full_answer_gap"], _gap(
            fa_ref[:real], fa[:real, 1:], banned))
    return out


def _row_dist(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest distance of a row of ``got`` from the reference's row, over
    the norm of the reference's row."""
    got, ref = got.float(), ref.float()
    num = torch.linalg.vector_norm(got - ref, dim=-1)
    den = torch.linalg.vector_norm(ref, dim=-1).clamp(min=1e-30)
    return float((num / den).max())


def _greedy(logits):
    lg = logits.float().clone()
    lg[..., ref_inputs.PAD] = float("-inf")
    lg[..., ref_inputs.SOS] = float("-inf")
    return lg.argmax(-1).to(torch.int32)


def judge(numbers: dict, lim: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit."""
    rows = [(k, float(numbers[k]), float(lim[k])) for k in lim]
    ok = all(np.isfinite(v) and v <= l for _, v, l in rows)
    return ok, rows
