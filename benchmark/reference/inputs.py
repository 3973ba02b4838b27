"""The reference's own reading of the raw traffic: tokens, vocabularies,
scene graphs and the padded dense batch, in plain Python, numpy and torch.

The benchmark builds the two vocabularies here and hands the same ones to
the program (whose dataset takes them as arguments) and to the reference;
everything else the program derives from the raw files (token ids, scene
graphs, the padded layout) is worked out again here from the same files.

Semantics, as published for GraphVQA's data path (and as the port keeps
them): whitespace tokens with punctuation, contractions and hyphen infixes
split off; ``<start>`` + ids + ``<end>`` padded with ``<pad>``; a scene's
nodes in sorted object-id order, each holding its name and up to 11
distinct attributes; a ``<self>`` loop before each node's relations, a
reverse edge with the same token added where the scene has none (its
embedding sign-flipped); the dense layout gives graph g node rows
[g*npg, g*npg + n) and edge rows [g*epg, g*epg + e), its edges stably
sorted by destination; the padding doubles npg and epg, each on its own,
until the batch's largest graph fits.
"""
from __future__ import annotations

import json
import pathlib
import re
from collections import Counter

import numpy as np
import torch

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
SPECIALS = ["<unk>", "<pad>", "<start>", "<end>"]
UNK, PAD, SOS, EOS = 0, 1, 2, 3
MAX_OBJ_TOKENS = 12
MAX_STEPS = 5

_CONTRACTION = re.compile(r"(?i)^(.+?)(n't|'s|'re|'ve|'ll|'d|'m)$")
_PUNCT = ".,!?;:\"()[]{}"
_INFIX = re.compile(r"(?<=[A-Za-z0-9])([\-/])(?=[A-Za-z0-9])")
_EXCEPTIONS = {"cannot": ["can", "not"], "gonna": ["gon", "na"],
               "gotta": ["got", "ta"], "wanna": ["wan", "na"],
               "lemme": ["lem", "me"]}


def tokenize(text: str) -> list:
    out = []
    for chunk in text.strip().split():
        lead, trail = [], []
        while chunk and (chunk[0] in _PUNCT
                         or chunk[0] == "'" and len(chunk) == 1):
            lead.append(chunk[0])
            chunk = chunk[1:]
        while chunk and chunk[-1] in _PUNCT:
            trail.append(chunk[-1])
            chunk = chunk[:-1]
        out.extend(lead)
        for part in _INFIX.split(chunk) if chunk else ():
            exc = (_EXCEPTIONS.get(part.lower())
                   if part.islower() or part.istitle() else None)
            if exc is not None:
                out.append(part[:len(exc[0])])
                out.extend(exc[1:])
                continue
            m = _CONTRACTION.match(part)
            if m and m.group(1):
                out.extend([m.group(1), m.group(2)])
            elif part:
                out.append(part)
        out.extend(reversed(trail))
    return out


def build_itos(token_lists) -> list:
    """Specials, then tokens by frequency (alphabetical among equals)."""
    counter = Counter()
    for toks in token_lists:
        counter.update(toks)
    words = sorted(counter.items())
    words.sort(key=lambda kv: kv[1], reverse=True)
    return list(SPECIALS) + [w for w, _ in words if w not in SPECIALS]


def text_itos(questions) -> list:
    """The question/program/full-answer vocabulary of a split."""
    lists = []
    for d in questions:
        lists += [tokenize(d[1]), list(d[6]), tokenize(d[5])]
    return build_itos(lists)


def scene_itos() -> list:
    """The scene-graph vocabulary: each line of the GQA metadata lists is
    one token, plus ``<self>``."""
    toks = []
    for name in ("name_gqa.txt", "attr_gqa.txt", "rel_gqa.txt"):
        toks += (ASSETS / name).read_text().splitlines()
    for name in ("objects.json", "predicates.json", "attributes.json"):
        toks += json.loads((ASSETS / name).read_text())
    return build_itos([toks + ["<self>"]])


def encode(ids, length: int) -> np.ndarray:
    ids = ([SOS] + list(ids) + [EOS])[:length]
    out = np.full((length,), PAD, np.int64)
    out[:len(ids)] = ids
    return out


def convert_scene(sg: dict, stoi: dict):
    """(node_tokens [n, 12], src, dst, edge_tokens, sym) of one scene."""
    look = lambda t: stoi.get(t, UNK)  # noqa: E731
    objs = sg["objects"]
    ids = sorted(objs)
    idx = {o: i for i, o in enumerate(ids)}
    nodes = np.full((len(ids), MAX_OBJ_TOKENS), PAD, np.int64)
    linked = {(idx[o], idx[r["object"]]) for o in ids
              for r in objs[o].get("relations", [])}
    src, dst, tok, sym = [], [], [], []
    for i, o in enumerate(ids):
        nodes[i, 0] = look(objs[o]["name"])
        for k, a in enumerate(dict.fromkeys(objs[o].get("attributes", []))):
            if k + 1 >= MAX_OBJ_TOKENS:
                break
            nodes[i, k + 1] = look(a)
        src.append(i), dst.append(i), tok.append(look("<self>"))
        sym.append(False)
        for r in objs[o].get("relations", []):
            j, t = idx[r["object"]], look(r["name"])
            src.append(i), dst.append(j), tok.append(t), sym.append(False)
            if (j, i) not in linked:
                src.append(j), dst.append(i), tok.append(t), sym.append(True)
    return nodes, np.asarray(src), np.asarray(dst), np.asarray(tok), \
        np.asarray(sym)


def rung(base: int, need: int, cap: int = 8) -> int:
    """The dense padding: ``base`` doubled until ``need`` fits."""
    v = base
    while v < need and v < base * cap:
        v *= 2
    if need > v:
        raise ValueError(f"{need} exceeds the dense ladder of {base}")
    return v


class Reader:
    """Rows of one split as the reference's tensors."""

    def __init__(self, questions, scenes, text_stoi: dict, scene_stoi: dict,
                 ans2label: dict, lengths: dict):
        self.questions, self.scenes = questions, scenes
        self.text, self.scene_stoi = text_stoi, scene_stoi
        self.ans2label, self.lengths = ans2label, lengths
        self._graphs, self._tokens, self._sizes = {}, {}, {}
        self._row_sizes = None

    def graph(self, image_id: str):
        g = self._graphs.get(image_id)
        if g is None:
            g = self._graphs[image_id] = convert_scene(
                self.scenes[image_id], self.scene_stoi)
        return g

    def sizes(self, image_id: str):
        """(nodes, edges, distinct sources, distinct destinations)."""
        got = self._sizes.get(image_id)
        if got is None:
            nodes, src, dst, _, _ = self.graph(image_id)
            got = self._sizes[image_id] = (
                len(nodes), len(src), len(np.unique(src)),
                len(np.unique(dst)))
        return got

    def token_counts(self, row: int):
        """(question tokens, [teacher-forced input tokens per program
        stream]) of a row, padding excluded."""
        c = self._tokens.get(row)
        if c is None:
            d, L = self.questions[int(row)], self.lengths
            q = min(len(tokenize(d[1])) + 2, L["question_len"])
            steps = list(d[9][:MAX_STEPS])
            steps += [[]] * (MAX_STEPS - len(steps))
            p = [min(len(s) + 2, L["program_len"] - 1) for s in steps]
            c = self._tokens[row] = (q, p)
        return c

    def batch(self, rows, npg: int, epg: int, num_graphs: int) -> dict:
        """The padded dense batch of dataset ``rows`` (repeating the last
        row up to ``num_graphs``): numpy arrays keyed as the reference
        model reads them."""
        rows = list(rows) + [rows[-1]] * (num_graphs - len(rows))
        B, L = num_graphs, self.lengths
        look = lambda t: self.text.get(t, UNK)  # noqa: E731
        node_tok = np.full((B, npg, MAX_OBJ_TOKENS), PAD, np.int64)
        node_mask = np.zeros((B, npg), bool)
        e_src = np.full((B, epg), npg - 1, np.int64)
        e_dst = np.full((B, epg), npg - 1, np.int64)
        e_tok = np.full((B, epg), PAD, np.int64)
        e_mask = np.zeros((B, epg), bool)
        e_sign = np.ones((B, epg), np.float32)
        q = np.zeros((B, L["question_len"]), np.int64)
        p = np.zeros((B * MAX_STEPS, L["program_len"]), np.int64)
        fa = np.zeros((B, L["full_answer_len"]), np.int64)
        label = np.zeros((B,), np.int64)
        for b, r in enumerate(rows):
            d = self.questions[int(r)]
            nodes, src, dst, tok, sym = self.graph(str(d[0]))
            n, e = len(nodes), len(src)
            node_tok[b, :n], node_mask[b, :n] = nodes, True
            order = np.argsort(dst, kind="stable")
            e_src[b, :e], e_dst[b, :e] = src[order], dst[order]
            e_tok[b, :e], e_mask[b, :e] = tok[order], True
            e_sign[b, :e] = np.where(sym[order], -1.0, 1.0)
            q[b] = encode([look(t) for t in tokenize(d[1])],
                          L["question_len"])
            steps = list(d[9][:MAX_STEPS])
            steps += [[]] * (MAX_STEPS - len(steps))
            for s, instr in enumerate(steps):
                p[b * MAX_STEPS + s] = encode([look(t) for t in instr],
                                              L["program_len"])
            fa[b] = encode([look(t) for t in tokenize(d[5])],
                           L["full_answer_len"])
            answer = "bottle" if d[4] == "bottle cap" else d[4]
            label[b] = self.ans2label[answer]
        return dict(node_tokens=node_tok, node_mask=node_mask, src=e_src,
                    dst=e_dst, edge_tokens=e_tok, edge_mask=e_mask,
                    edge_sign=e_sign, questions=q, programs=p,
                    full_answers=fa, labels=label, npg=npg, epg=epg)

    def shape(self, rows, npg: int, epg: int):
        """The dense rung (npg, epg) that ``rows`` reach from the base."""
        sizes = [self.sizes(str(self.questions[int(r)][0])) for r in rows]
        return (rung(npg, max(s[0] for s in sizes)),
                rung(epg, max(s[1] for s in sizes)))

    def row_sizes(self):
        """[rows, 2] nodes and edges of every row's scene."""
        if self._row_sizes is None:
            per_scene = {i: self.sizes(i)[:2] for i in self.scenes}
            self._row_sizes = np.asarray(
                [per_scene[str(d[0])] for d in self.questions], np.int64)
        return self._row_sizes


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}
