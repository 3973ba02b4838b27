"""The engines the benchmark's configurations run, one file each:
``engines/<kind>.py`` for the configuration's ``engine.kind``.

An engine file is reference code (it imports nothing of the program) and
gives:
  * ``forward(ref, x, e, memory, instr, b, gen, ctx_gen, train) -> h``: the
    plain engine on the reference's padded dense layout, the helpers that
    several engines use reached through ``ref`` (``reference/model.py``);
  * ``flops(cfg, n, e, q) -> (ops, node_dim)``: the engine's forward
    operations on a batch's real nodes, edges and question tokens, and the
    width of the node features it hands the pooling (``counts/flops.py``);
  * ``init_rule(name, shape) -> rule or None``: the published
    initialisation of the engine's own leaves, ``None`` for the shared rules
    (``harness/weights.py``);
  * optionally ``kernel_bytes(cfg, counts, train) -> (forward, backward)``:
    the fewest bytes the engine's hand-written kernels move over the traced
    batches (``counts`` as ``harness/common.py:batch_counts`` gives them);
    an engine without kernels leaves it out and reads (0, 0).

A configuration with another engine is added as ``configs/<name>.json``
plus ``engines/<kind>.py``; nothing else looks at the kind.
"""
from __future__ import annotations

import importlib
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent


def load(kind: str):
    """The engine module of ``kind``; a kind with no file fails here."""
    if not re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9_]*", kind) or \
            not (HERE / f"{kind}.py").is_file():
        raise FileNotFoundError(
            f"no engine file for kind {kind!r}: add "
            f"benchmark/engines/{kind}.py (its reference forward, flops and "
            f"init_rule; engines/__init__.py says what each gives)")
    return importlib.import_module(f"engines.{kind}")
