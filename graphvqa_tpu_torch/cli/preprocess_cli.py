"""Offline preprocessing CLI (reference: preprocess.py:599-697 driver; the
port's own copy of ``graphvqa_tpu/cli/preprocess_cli.py``).

    python -m graphvqa_tpu_torch.cli.preprocess_cli --data-root /path/to/GraphVQA \
        [--val-all]

Expects the GQA layout under --data-root:
    questions/original/{split}_questions.json
    sceneGraphs/{train,val}_sceneGraphs.json
Writes questions/{split}_programs.json (11-field tuples).

``--audit-tokens FILE`` instead runs the tokenizer risk audit
(data/token_audit.py) over a raw questions JSON or a *_programs.json:
construct coverage, suspicious/unknown token rates, and a live spacy
mismatch rate when spacy is importable.  Pass ``--vocab text_vocab.json``
to include unknown-rate against a concrete vocabulary.
"""
from __future__ import annotations

import argparse
import pathlib

from graphvqa_tpu_torch.data.preprocess import preprocess_file


def main():
    p = argparse.ArgumentParser("GraphVQA preprocessing (PyTorch)")
    p.add_argument("--data-root", default="",
                   help="GQA root (required unless --audit-tokens)")
    p.add_argument("--val-all", action="store_true",
                   help="also generate val_all programs (for consistency "
                        "scoring)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for choose-argument shuffling (None in the "
                        "reference; seeded here for reproducibility)")
    p.add_argument("--audit-tokens", default="", metavar="FILE",
                   help="audit tokenizer risk over this questions/programs "
                        "JSON and exit")
    p.add_argument("--vocab", default="",
                   help="text_vocab.json for the audit's unknown-token rate")
    args = p.parse_args()

    if args.audit_tokens:
        from graphvqa_tpu_torch.data.token_audit import audit_file, format_report
        print(format_report(audit_file(args.audit_tokens,
                                       args.vocab or None)))
        return
    if not args.data_root:
        p.error("--data-root is required (or use --audit-tokens)")

    root = pathlib.Path(args.data_root)
    q = root / "questions"
    sg = root / "sceneGraphs"

    # testdev has no GT scene graphs (gqa_dataset_entry.py:92-95)
    preprocess_file(q / "original" / "testdev_balanced_questions.json",
                    q / "testdev_balanced_programs.json", None, args.seed)
    preprocess_file(q / "original" / "val_balanced_questions.json",
                    q / "val_balanced_programs.json",
                    sg / "val_sceneGraphs.json", args.seed)
    preprocess_file(q / "original" / "train_balanced_questions.json",
                    q / "train_balanced_programs.json",
                    sg / "train_sceneGraphs.json", args.seed)
    if args.val_all:
        preprocess_file(q / "original" / "val_all_questions.json",
                        q / "val_all_programs.json",
                        sg / "val_sceneGraphs.json", args.seed)


if __name__ == "__main__":
    main()
