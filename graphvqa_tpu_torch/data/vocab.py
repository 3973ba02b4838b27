"""Vocabulary: torchtext-compatible ordering, JSON artifacts, GloVe hook (the
port's own copy of ``graphvqa_tpu/data/vocab.py``, reading the port's
``assets/meta_info``).

Replaces torchtext ``Field``/``Vocab`` + the pickled ``GQA_TEXT_obj.pkl``
(reference: gqa_dataset_entry.py:56-61,390-398,546-578; K7) with a plain JSON
artifact. Index layout matches torchtext's specials order so token ids line up
with the reference: ``<unk>=0, <pad>=1, <start>=2, <end>=3`` (Constants.py:18-21),
then corpus tokens sorted (alphabetical tiebreak, frequency-descending primary)
exactly like ``torchtext.vocab.Vocab``.
"""
from __future__ import annotations

import json
import pathlib
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

SPECIALS = ["<unk>", "<pad>", "<start>", "<end>"]
UNK, PAD, SOS, EOS = 0, 1, 2, 3

_ASSET_DIR = pathlib.Path(__file__).resolve().parent.parent / "assets" / "meta_info"


class Vocab:
    def __init__(self, itos: List[str]):
        self.itos = list(itos)
        self.stoi: Dict[str, int] = {t: i for i, t in enumerate(self.itos)}
        # torchtext defaultdict-style: unknown tokens -> 0
        self.unk_index = UNK

    def __len__(self) -> int:
        return len(self.itos)

    def __getitem__(self, token: str) -> int:
        return self.stoi.get(token, self.unk_index)

    def lookup(self, token: str) -> int:
        return self.stoi.get(token, self.unk_index)

    def encode(self, tokens: Sequence[str], length: int,
               add_sos_eos: bool = True) -> np.ndarray:
        """Numericalize + pad to a static length (torchtext Field.process)."""
        return self.encode_ids([self.lookup(t) for t in tokens], length,
                               add_sos_eos)

    def encode_ids(self, ids: Sequence[int], length: int,
                   add_sos_eos: bool = True) -> np.ndarray:
        """Pad pre-numericalized ids to a static length (the lookup half of
        :meth:`encode` is cacheable per dataset row — data/dataset.py)."""
        ids = list(ids)
        if add_sos_eos:
            ids = [SOS] + ids + [EOS]
        ids = ids[:length]
        out = np.full((length,), PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids: Iterable[int], join: bool = True):
        """Ids -> sentence, skipping pad/start, stopping at end, gluing
        punctuation (reference: gqa_dataset_entry.py:580-607)."""
        words: List[str] = []
        for i in ids:
            w = self.itos[int(i)] if 0 <= int(i) < len(self.itos) else "<unk>"
            if w in ("<pad>", "<start>"):
                continue
            if w == "<end>":
                break
            if words and w in ("'", ".", "?", "!", ","):
                words[-1] += w
            else:
                words.append(w)
        return " ".join(words) if join else words

    _PUNCT = ("'", ".", "?", "!", ",")

    def decode_batch(self, ids: np.ndarray) -> List[str]:
        """Vectorized :meth:`decode` over a [R, L] id matrix -> R sentences.

        Identical output to ``[self.decode(row) for row in ids]`` but the
        per-token work (bounds check, special-token skip, end-stop) runs as
        numpy array ops — validate()'s dump path decodes ``2 * B * M`` rows
        per batch, and per-row Python would bound the host side of eval."""
        if not hasattr(self, "_np_tables"):
            itos_arr = np.asarray(self.itos, dtype=object)
            skip = np.asarray([t in ("<pad>", "<start>") for t in self.itos])
            end = np.asarray([t == "<end>" for t in self.itos])
            punct = np.asarray([t in self._PUNCT for t in self.itos])
            self._np_tables = (itos_arr, skip, end, punct)
        itos_arr, skip_m, end_m, punct_m = self._np_tables
        ids = np.asarray(ids)
        if ids.ndim == 1:
            ids = ids[None]
        R, L = ids.shape
        oob = (ids < 0) | (ids >= len(self.itos))
        ids = np.where(oob, self.unk_index, ids).astype(np.int64)
        end = end_m[ids]
        stop = np.where(end.any(1), end.argmax(1), L)
        keep = (np.arange(L)[None, :] < stop[:, None]) & ~skip_m[ids]
        has_punct = (punct_m[ids] & keep).any(1).tolist()
        # one flat gather for all rows, then split by per-row counts (per-row
        # numpy indexing dominates at these row sizes)
        all_words = itos_arr[ids[keep]].tolist()
        counts = keep.sum(1).tolist()
        out: List[str] = []
        start = 0
        for c, hp in zip(counts, has_punct):
            ws = all_words[start:start + c]
            start += c
            if hp:
                glued: List[str] = []
                for w in ws:
                    if glued and w in self._PUNCT:
                        glued[-1] += w
                    else:
                        glued.append(w)
                ws = glued
            out.append(" ".join(ws))
        return out

    @classmethod
    def build(cls, token_lists: Iterable[Sequence[str]],
              min_freq: int = 1) -> "Vocab":
        counter: Counter = Counter()
        for toks in token_lists:
            counter.update(toks)
        # torchtext order: alphabetical, then stable-sorted by freq descending
        words = sorted(counter.items())
        words.sort(key=lambda kv: kv[1], reverse=True)
        itos = list(SPECIALS) + [w for w, c in words
                                 if c >= min_freq and w not in SPECIALS]
        return cls(itos)

    def save(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps({"itos": self.itos}))

    @classmethod
    def load(cls, path) -> "Vocab":
        return cls(json.loads(pathlib.Path(path).read_text())["itos"])


def _load_lines(path: pathlib.Path) -> List[str]:
    return path.read_text().splitlines()


def build_scene_graph_vocab(asset_dir: Optional[pathlib.Path] = None) -> Vocab:
    """SG vocab from the GQA metadata assets + ``<self>``.

    Token granularity matches the reference exactly: each *line* (possibly
    multi-word, e.g. "to the left of") is one token, because the reference
    passes the raw line list as a single pre-tokenized example
    (gqa_dataset_entry.py:152-162).
    """
    d = asset_dir or _ASSET_DIR
    toks: List[str] = []
    toks += _load_lines(d / "name_gqa.txt")
    toks += _load_lines(d / "attr_gqa.txt")
    toks += _load_lines(d / "rel_gqa.txt")
    toks += json.loads((d / "objects.json").read_text())
    toks += json.loads((d / "predicates.json").read_text())
    toks += json.loads((d / "attributes.json").read_text())
    toks.append("<self>")
    return Vocab.build([toks])


def build_text_vocab(data: Sequence, tokenizer) -> Vocab:
    """QA-side vocab from dataset tuples (question, program tokens, full
    answer), mirroring build_qa_vocab (gqa_dataset_entry.py:546-566)."""
    lists = []
    for datum in data:
        question_text = datum[1]
        program_text_tokenized = datum[6]
        full_answer_text = datum[5]
        lists.append(tokenizer(question_text))
        lists.append(list(program_text_tokenized))
        lists.append(tokenizer(full_answer_text))
    return Vocab.build(lists)


def load_answer_maps(asset_dir: Optional[pathlib.Path] = None):
    """The 1842-way short-answer bijection (gqa_dataset_entry.py:407-413)."""
    d = asset_dir or _ASSET_DIR
    ans2label = json.loads((d / "trainval_ans2label.json").read_text())
    label2ans = json.loads((d / "trainval_label2ans.json").read_text())
    assert len(ans2label) == len(label2ans)
    for ans, label in ans2label.items():
        assert label2ans[label] == ans
    return ans2label, label2ans


def load_glove_matrix(vocab: Vocab, glove_path,
                      dim: int = 300, allow_missing: bool = False
                      ) -> np.ndarray:
    """Build an embedding init matrix from a GloVe text file; rows missing
    from GloVe get zeros (torchtext behavior). The artifact is saved as .npy
    and consumed at model-init time.

    A nonexistent file raises unless ``allow_missing=True`` — a typo'd path
    must not silently train with all-zero injected embeddings."""
    mat = np.zeros((len(vocab), dim), dtype=np.float32)
    glove_path = pathlib.Path(glove_path)
    if not glove_path.exists():
        if allow_missing:
            return mat
        raise FileNotFoundError(
            f"GloVe file not found: {glove_path} — pass "
            f"--glove-allow-missing to proceed with zero embeddings")
    want = set(vocab.stoi)
    with glove_path.open() as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if parts[0] in want:
                mat[vocab.stoi[parts[0]]] = np.asarray(parts[1:], np.float32)
    return mat
