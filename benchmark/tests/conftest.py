"""The benchmark's own tests: CPU tests at a tiny width, and card tests
(marked ``cuda``) that skip without a card.

    python -m pytest benchmark/tests -q
"""
import copy
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.append(str(BENCH.parent))


def shrink(cfg: dict, tr: dict, dtype: str = "float32"):
    """A configuration and traffic at a width and size a CPU test holds:
    the same tree, its widths cut, a few hundred questions, B=8."""
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    m = cfg["model"]
    m["text"]["emb_dim"] = m["scene"]["emb_dim"] = 48
    m["transformer"].update(hidden_dim=64, num_heads=4, ffn_dim=128,
                            num_layers=2)
    m["classifier_hidden"] = 64
    m["dtype"] = dtype
    train = tr["mode"] == "train"
    tr.update(questions=320 if train else 96, scenes=32 if train else 24,
              workers=2, trace_at=0.3, trace_steps=2)
    tr["batch"]["num_graphs"] = 8
    return cfg, tr


@pytest.fixture
def tiny():
    return shrink
