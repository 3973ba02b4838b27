"""English tokenizer for questions / programs / full answers (the port's own
copy of ``graphvqa_tpu/data/tokenizer.py``).

The reference tokenizes with spacy's ``en_core_web_sm`` through torchtext
(reference: gqa_dataset_entry.py:390-394). This is a dependency-free
rule-based tokenizer covering the constructs that actually occur in GQA text:
punctuation separation, English contractions, and possessives. GQA questions
are short templated English, so these rules reproduce spacy's segmentation on
that distribution.
"""
from __future__ import annotations

import re
from typing import List

# contractions spacy splits into two tokens: do|n't, it|'s, you|'re ...
_CONTRACTION = re.compile(
    r"(?i)^(.+?)(n't|'s|'re|'ve|'ll|'d|'m)$")
_PUNCT = ".,!?;:\"()[]{}"
# spacy infix rule: hyphens/slashes between letters split into three tokens
# ("t-shirt" -> t | - | shirt), matching en_core_web_sm's infix patterns
_INFIX = re.compile(r"(?<=[A-Za-z0-9])([\-/])(?=[A-Za-z0-9])")
# spacy tokenizer-exception table entries that the contraction regex can't
# derive (en_core_web_sm splits these mid-word)
_EXCEPTIONS = {
    "cannot": ["can", "not"],
    "gonna": ["gon", "na"],
    "gotta": ["got", "ta"],
    "wanna": ["wan", "na"],
    "lemme": ["lem", "me"],
}


def tokenize(text: str) -> List[str]:
    out: List[str] = []
    for chunk in text.strip().split():
        _tokenize_chunk(chunk, out)
    return out


def _tokenize_chunk(chunk: str, out: List[str]) -> None:
    if not chunk:
        return
    # strip leading punctuation
    lead = []
    while chunk and (chunk[0] in _PUNCT or chunk[0] == "'" and len(chunk) == 1):
        lead.append(chunk[0])
        chunk = chunk[1:]
    trail = []
    while chunk and chunk[-1] in _PUNCT:
        trail.append(chunk[-1])
        chunk = chunk[:-1]
    out.extend(lead)
    for part in _INFIX.split(chunk) if chunk else ():
        # spacy's exception table is case-sensitive and only contains
        # lowercase and title-case entries ("cannot"/"Cannot", not
        # "CANNOT") — other casings pass through as one token
        exc = (_EXCEPTIONS.get(part.lower())
               if part.islower() or part.istitle() else None)
        if exc is not None:
            # preserve the original casing of the first piece like spacy
            # ("Cannot" -> "Can", "not")
            first = part[: len(exc[0])]
            out.append(first)
            out.extend(exc[1:])
            continue
        m = _CONTRACTION.match(part)
        if m and m.group(1):
            out.append(m.group(1))
            out.append(m.group(2))
        elif part:
            out.append(part)
    out.extend(reversed(trail))
