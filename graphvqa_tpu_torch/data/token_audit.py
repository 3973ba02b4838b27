"""Tokenizer risk audit over real question files (the port's own copy of
``graphvqa_tpu/data/token_audit.py``).

The rule tokenizer (data/tokenizer.py) stands in for the reference's
spacy-through-torchtext tokenization (gqa_dataset_entry.py:390-398).  With
the reference vocab importable (data/torchtext_import.py) a converted
checkpoint no longer depends on tokenizer parity for *indexing*, but
segmentation still decides which ids a question maps to at eval time.  This
audit bounds that risk on any real data the user has, instead of trusting a
pinned test corpus (VERDICT r3 weak 1 / item 3):

  * construct-class coverage: counts of contractions, possessives, hyphen/
    slash infixes, numerics, quotes, non-ascii — the places tokenizers
    disagree;
  * suspicious tokens: characters outside the ascii classes the rule
    tokenizer was designed for (these are where divergence is likeliest);
  * unknown-token rate vs a given vocab (embedding rows that fall to <unk>);
  * live spacy mismatch rate + examples, when spacy/en_core_web_sm is
    importable (it is not in CI, so this is a field diagnostic).

Input: a raw GQA questions JSON (dict qid -> {question, fullAnswer, ...})
or a preprocessed ``*_programs.json`` (list of 11-field tuples).
"""
from __future__ import annotations

import json
import pathlib
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

from graphvqa_tpu_torch.data.tokenizer import tokenize

_CONSTRUCTS = {
    "contraction": re.compile(r"(?i)\b\w+(n't|'re|'ve|'ll|'d|'m)\b"),
    "possessive_or_is": re.compile(r"(?i)\b\w+'s\b"),
    "hyphen_infix": re.compile(r"[A-Za-z0-9]-[A-Za-z0-9]"),
    "slash_infix": re.compile(r"[A-Za-z0-9]/[A-Za-z0-9]"),
    "numeric": re.compile(r"\d"),
    "quote": re.compile(r"[\"“”‘’]"),
    "multi_punct": re.compile(r"[.,!?;:]{2,}"),
    "non_ascii": re.compile(r"[^\x00-\x7f]"),
}
_OK_TOKEN = re.compile(r"^[A-Za-z0-9]+$|^[.,!?;:\"'()\[\]{}/-]+$"
                       r"|^(?i:n't|'s|'re|'ve|'ll|'d|'m)$")


def iter_texts(data) -> Iterable[str]:
    """Texts the reference tokenizes: question + fullAnswer
    (gqa_dataset_entry.py:510-511,556-566)."""
    if isinstance(data, dict):          # raw GQA questions file
        for q in data.values():
            yield q.get("question", "")
            if q.get("fullAnswer"):
                yield q["fullAnswer"]
    else:                               # 11-field program tuples
        for datum in data:
            yield datum[1]
            if len(datum) > 5 and datum[5]:
                yield datum[5]


def audit_tokens(
    texts: Iterable[str],
    vocab=None,
    spacy_sample: int = 20000,
) -> Dict:
    """Run the audit; returns a JSON-able report dict."""
    n_texts = 0
    n_tokens = 0
    construct_counts: Counter = Counter()
    suspicious: Counter = Counter()
    unknown: Counter = Counter()

    nlp = None
    try:  # live spacy, when available
        import spacy
        nlp = spacy.load("en_core_web_sm")
    except Exception:
        pass
    spacy_checked = spacy_mismatch = 0
    mismatch_examples: List[Tuple[str, List[str], List[str]]] = []

    for text in texts:
        n_texts += 1
        toks = tokenize(text)
        n_tokens += len(toks)
        for name, pat in _CONSTRUCTS.items():
            if pat.search(text):
                construct_counts[name] += 1
        for t in toks:
            if not _OK_TOKEN.match(t):
                suspicious[t] += 1
            if vocab is not None and vocab.lookup(t) == 0 \
                    and t not in ("<unk>",):
                unknown[t] += 1
        if nlp is not None and spacy_checked < spacy_sample:
            spacy_checked += 1
            want = [t.text for t in nlp.tokenizer(text)]
            if want != toks:
                spacy_mismatch += 1
                if len(mismatch_examples) < 20:
                    mismatch_examples.append((text, toks, want))

    report = {
        "n_texts": n_texts,
        "n_tokens": n_tokens,
        "construct_counts": dict(construct_counts),
        "suspicious_token_count": sum(suspicious.values()),
        "suspicious_token_rate": (sum(suspicious.values())
                                  / max(n_tokens, 1)),
        "suspicious_top": suspicious.most_common(20),
    }
    if vocab is not None:
        report["unknown_token_count"] = sum(unknown.values())
        report["unknown_token_rate"] = sum(unknown.values()) / max(n_tokens,
                                                                   1)
        report["unknown_top"] = unknown.most_common(20)
    if nlp is not None:
        report["spacy_checked"] = spacy_checked
        report["spacy_mismatch"] = spacy_mismatch
        report["spacy_mismatch_rate"] = spacy_mismatch / max(spacy_checked, 1)
        report["spacy_mismatch_examples"] = mismatch_examples
    else:
        report["spacy"] = "not importable here; rerun where spacy + " \
                          "en_core_web_sm are installed for a live check"
    return report


def audit_file(path, vocab_path: Optional[str] = None) -> Dict:
    data = json.loads(pathlib.Path(path).read_text())
    vocab = None
    if vocab_path:
        from graphvqa_tpu_torch.data.vocab import Vocab
        vocab = Vocab.load(vocab_path)
    return audit_tokens(iter_texts(data), vocab=vocab)


def format_report(report: Dict) -> str:
    lines = [f"texts: {report['n_texts']}   tokens: {report['n_tokens']}"]
    lines.append("construct coverage (texts containing):")
    for k in _CONSTRUCTS:
        lines.append(f"  {k}: {report['construct_counts'].get(k, 0)}")
    lines.append(f"suspicious tokens: {report['suspicious_token_count']} "
                 f"({100 * report['suspicious_token_rate']:.4f}%)")
    for tok, c in report.get("suspicious_top", []):
        lines.append(f"  {tok!r}: {c}")
    if "unknown_token_rate" in report:
        lines.append(f"unknown tokens vs vocab: "
                     f"{report['unknown_token_count']} "
                     f"({100 * report['unknown_token_rate']:.4f}%)")
        for tok, c in report.get("unknown_top", []):
            lines.append(f"  {tok!r}: {c}")
    if "spacy_mismatch_rate" in report:
        lines.append(
            f"live spacy mismatches: {report['spacy_mismatch']}/"
            f"{report['spacy_checked']} "
            f"({100 * report['spacy_mismatch_rate']:.4f}%)")
        for text, ours, want in report.get("spacy_mismatch_examples", []):
            lines.append(f"  {text!r}\n    ours:  {ours}\n    spacy: {want}")
    else:
        lines.append(f"live spacy check: {report.get('spacy', 'n/a')}")
    return "\n".join(lines)
