"""Torchtext-free import of the reference's pickled text vocabulary (the
port's own copy of ``graphvqa_tpu/data/torchtext_import.py``).

The reference persists its QA-side vocabulary as a pickled torchtext
``Field`` object, ``questions/GQA_TEXT_obj.pkl``
(reference: gqa_dataset_entry.py:546-578).  A converted checkpoint's
``text_vocab_embedding`` rows are indexed by that vocab's ``itos`` order, so
migration correctness requires importing the *exact* reference ordering —
not rebuilding a vocab with our tokenizer and hoping the frequency table
matches token for token.

This module unpickles the Field WITHOUT torchtext installed: every
``torchtext.*`` symbol the pickle references is resolved to a generic stub
that just captures instance state (pickle only needs the class to allocate
an instance and hand it ``__setstate__``/``__dict__``).  ``torch`` tensors
inside (the GloVe ``vocab.vectors``) unpickle normally — torch is a real
dependency here.  We then walk the object graph for the vocab's ``itos``
list and optional ``vectors`` matrix.

Security note: this still executes the pickle protocol, so only feed it
files you trust (the user's own reference checkout) — same trust level as
``torch.load`` on the reference checkpoint itself.
"""
from __future__ import annotations

import io
import pathlib
import pickle
from typing import Any, List, Optional, Tuple

import numpy as np

_STUB_PREFIXES = ("torchtext.",)


class _Stub:
    """Stand-in for any torchtext class in the pickle.

    Instances only need to hold state: pickle allocates via ``__new__`` and
    then either calls ``__setstate__`` (we merge dict states into
    ``__dict__``) or updates ``__dict__`` directly.  The class is also
    callable-as-function so that pickled *function* references (e.g.
    ``torchtext.vocab._default_unk_index``, the ``stoi`` defaultdict
    factory) resolve to something invocable.
    """

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            # protocol-2 (dict_state, slots_state) form
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self.__dict__["_state"] = state


def _make_stub(module: str, name: str) -> type:
    return type(name, (_Stub,), {"__module__": module})


class _TorchtextFreeUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "torchtext" or any(
                module.startswith(p) for p in _STUB_PREFIXES):
            return _make_stub(module, name)
        return super().find_class(module, name)


def _iter_objects(root: Any):
    """BFS over an unpickled object graph (dicts, lists, stub instances)."""
    seen = set()
    queue = [root]
    while queue:
        obj = queue.pop()
        oid = id(obj)
        if oid in seen:
            continue
        seen.add(oid)
        yield obj
        if isinstance(obj, dict):
            queue.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            queue.extend(obj)
        elif hasattr(obj, "__dict__"):
            queue.extend(vars(obj).values())


def extract_itos(obj: Any) -> List[str]:
    """Find the vocab's ``itos`` token list anywhere in the object graph."""
    for node in _iter_objects(obj):
        d = node if isinstance(node, dict) else getattr(node, "__dict__", None)
        if not isinstance(d, dict):
            continue
        itos = d.get("itos")
        if (isinstance(itos, list) and itos
                and all(isinstance(t, str) for t in itos[:64])):
            return list(itos)
    raise ValueError(
        "no `itos` token list found in the pickle — is this really a "
        "torchtext Field/Vocab pickle (GQA_TEXT_obj.pkl)?")


def extract_vectors(obj: Any) -> Optional[np.ndarray]:
    """Find the vocab's pretrained ``vectors`` matrix, if pickled with one
    (``build_vocab(..., vectors='glove.6B.300d')``,
    reference gqa_dataset_entry.py:565)."""
    for node in _iter_objects(obj):
        d = node if isinstance(node, dict) else getattr(node, "__dict__", None)
        if not isinstance(d, dict) or "itos" not in d:
            continue
        vec = d.get("vectors")
        if vec is None:
            continue
        if hasattr(vec, "detach"):  # torch.Tensor
            vec = vec.detach().cpu().numpy()
        arr = np.asarray(vec, dtype=np.float32)
        if arr.ndim == 2 and arr.shape[0] == len(d["itos"]):
            return arr
    return None


def load_torchtext_field(path) -> Tuple[List[str], Optional[np.ndarray]]:
    """Unpickle a torchtext Field/Vocab pickle without torchtext.

    Returns ``(itos, vectors_or_None)``.
    """
    data = pathlib.Path(path).read_bytes()
    obj = _TorchtextFreeUnpickler(io.BytesIO(data)).load()
    itos = extract_itos(obj)
    return itos, extract_vectors(obj)


def import_reference_vocab(pkl_path, json_out,
                           glove_out=None) -> Tuple[int, bool]:
    """Convert ``GQA_TEXT_obj.pkl`` -> ``text_vocab.json`` (+ optional GloVe
    ``.npy`` aligned to that vocab).  Returns (vocab_size, wrote_glove).

    The emitted JSON is exactly what the trainer loads
    (cli/train_cli.py: ``out_dir/text_vocab.json``), so a converted
    checkpoint's embedding rows line up with token ids independent of the
    local rule tokenizer.
    """
    from graphvqa_tpu_torch.data.vocab import Vocab

    itos, vectors = load_torchtext_field(pkl_path)
    Vocab(itos).save(json_out)
    wrote_glove = False
    if glove_out is not None and vectors is not None:
        np.save(glove_out, vectors)
        wrote_glove = True
    return len(itos), wrote_glove
