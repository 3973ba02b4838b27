#!/usr/bin/env python3
"""Why a family's f32 train step differs between the card and the CPU.

    python3 tools/family_gradient_flips.py [gine lcgn ...]

For each named family of chip_smoke.py's phase 12 (gcn, gine, lcgn, onlysg,
exec; default gine and lcgn): one float32 train step of the full-width
model (dropout 0) on phase 8's B=8 batch, from the same weights, on the CPU
and twice on the card (LCGN's context features one fixed draw), with no
ReLU input set to the CPU's (phase 12 sets them; this shows why). Prints, for
the six tensors whose gradient differs most between card and CPU: the
largest difference over the tensor's largest |gradient|, the difference's
norm over the gradient's, how many elements differ by more than 1e-3 of
the tensor's scale, and the same largest difference between the two card
runs (the card's own run-to-run noise). Then, at the inputs of the ReLUs
that follow a module (``chip_smoke.relu_inputs``, first call of each), the
elements whose sign differs between card and CPU, with the largest |input|
among them: a ReLU input within round-off of 0 can fall either way, and
then its unit's gradient moves by its whole share. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def step(cfg, batch, noise, device, hooks):
    """One train step -> (loss, {param: grad}, {module: relu input})."""
    import torch
    import chip_smoke as cs
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    model = cs.fixed_ctx(cs.full_model(cfg, device), noise)
    record = cs.watch_relu_inputs(model)[0] if hooks else {}
    _, m = make_train_step(model, cfg)(
        create_train_state(model, lr=cfg.train.lr), batch.to(device),
        torch.Generator(device=device).manual_seed(0))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
             for n, p in model.named_parameters()}
    return float(m["total"]), grads, {n: v[0] for n, v in record.items()}


def main(names) -> None:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    for name in names:
        base = cs.family_config(name)
        mc = base.model
        cfg = dataclasses.replace(base, model=dataclasses.replace(
            mc, dtype="float32", classifier_dropout=0.0,
            transformer=dataclasses.replace(mc.transformer, dropout=0.0),
            engine=dataclasses.replace(mc.engine, dropout=0.0)))
        batch = cs.qa_batch(cfg, 8, seed=21)
        noise = cs.ctx_noise(cfg, batch)
        lc, gc, ac = step(cfg, batch, noise, "cpu", True)
        l1, g1, a1 = step(cfg, batch, noise, dev, True)
        _, g2, _ = step(cfg, batch, noise, dev, False)
        print(f"{name}: loss cpu {lc:.7f} card {l1:.7f}")
        rows = []
        for n, c in gc.items():
            scale = float(c.abs().max())
            if scale <= 1e-5:
                continue
            d = g1[n] - c
            rows.append((float(d.abs().max()) / scale,
                         float(d.norm() / c.norm()),
                         int((d.abs() > 1e-3 * scale + 1e-7).sum()),
                         c.numel(),
                         float((g2[n] - g1[n]).abs().max()) / scale, n))
        rows.sort(reverse=True)
        for r in rows[:6]:
            print(f"  {r[5]}: card-cpu max {r[0]:.2e} of scale, norm "
                  f"{r[1]:.2e}, {r[2]}/{r[3]} elements over 1e-3; "
                  f"card-card max {r[4]:.2e}")
        for n, x in ac.items():
            flips = (x > 0) != (a1[n] > 0)
            if bool(flips.any()):
                print(f"  relu input {n}: {int(flips.sum())} of "
                      f"{flips.numel()} signs differ, largest |x| among "
                      f"them {float(x[flips].abs().max()):.2e}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["gine", "lcgn"])
