"""The port's host data path against the JAX package's, on the CPU.

The same files go through both packages: the bundled debug fixture and a
small seeded synthetic set written by the port's generator (itself held
byte-equal to ``tools/make_synthetic_gqa.py``). Everything here is exact:
token lists, vocabularies, scene-graph arrays, collated batches
(byte-equal, with the native and the numpy packer, in the configured dense
shape, a bumped rung of the ladder and the flat fallback), batch orders and
the GloVe rows.
"""
import dataclasses
import filecmp
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import graphvqa_tpu.core.native as jnative
import graphvqa_tpu.data.dataset as jdataset
import graphvqa_tpu_torch.core.native as pnative
import graphvqa_tpu_torch.data.dataset as pdataset
from graphvqa_tpu.config import BatchConfig as JaxBatchConfig
from graphvqa_tpu.data import constants as jconstants
from graphvqa_tpu.data import lemmatizer as jlemmatizer
from graphvqa_tpu.data import scene_graph as jscene
from graphvqa_tpu.data import tokenizer as jtokenizer
from graphvqa_tpu.data import vocab as jvocab
from graphvqa_tpu.models.pretrained import (
    inject_pretrained_embeddings as jax_inject)
from graphvqa_tpu_torch.config import BatchConfig
from graphvqa_tpu_torch.data import constants as pconstants
from graphvqa_tpu_torch.data import lemmatizer as plemmatizer
from graphvqa_tpu_torch.data import scene_graph as pscene
from graphvqa_tpu_torch.data import tokenizer as ptokenizer
from graphvqa_tpu_torch.data import vocab as pvocab
from graphvqa_tpu_torch.data.synthetic import (
    write_scorer_questions, write_synthetic_gqa)
from graphvqa_tpu_torch.eval.scorer import score_predictions
from graphvqa_tpu_torch.models.convert import from_jax_variables
from graphvqa_tpu_torch.models.pretrained import inject_pretrained_embeddings
from tests.torch_port_helpers import (
    jax_variables, port_model, tiny_model_config)

REPO = pathlib.Path(__file__).resolve().parent.parent
# the port's meta also carries each batch's collate time and the process
# that collated it, which the JAX package's does not
COLLATE_TIMING = ("collate_s", "collate_pid")
JAX_ASSETS = REPO / "graphvqa_tpu" / "assets"
PORT_ASSETS = REPO / "graphvqa_tpu_torch" / "assets"
DEBUG = PORT_ASSETS / "debug"


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    out = tmp_path_factory.mktemp("syn")
    write_synthetic_gqa(out, train_questions=320, val_questions=64,
                        scenes=60, seed=5)
    return out


@pytest.fixture(scope="module")
def debug_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("debug")
    (root / "questions").mkdir()
    (root / "sceneGraphs").mkdir()
    (root / "questions" / "debug_programs.json").write_bytes(
        (DEBUG / "debug_programs.json").read_bytes())
    (root / "sceneGraphs" / "val_sceneGraphs.json").write_bytes(
        (DEBUG / "debug_sceneGraphs.json").read_bytes())
    return root


def _split(name, debug_root, synthetic):
    """(programs, scenes) paths of the debug fixture or the synthetic set."""
    if name == "debug":
        return (debug_root / "questions" / "debug_programs.json",
                debug_root / "sceneGraphs" / "val_sceneGraphs.json")
    return (synthetic / "questions" / "train_balanced_programs.json",
            synthetic / "sceneGraphs" / "train_sceneGraphs.json")


@pytest.mark.parametrize("folder", ["meta_info", "debug"])
def test_assets_are_byte_equal_copies(folder):
    names = sorted(p.name for p in (JAX_ASSETS / folder).iterdir())
    assert names == sorted(p.name for p in (PORT_ASSETS / folder).iterdir())
    match, mismatch, errors = filecmp.cmpfiles(
        JAX_ASSETS / folder, PORT_ASSETS / folder, names, shallow=False)
    assert (mismatch, errors) == ([], [])


def test_synthetic_generator_writes_the_tools_bytes(tmp_path):
    """The port's generator and tools/make_synthetic_gqa.py, same seed."""
    args = ["--train-questions", "150", "--val-questions", "30", "--scenes",
            "40", "--seed", "9"]
    tool = REPO / "tools" / "make_synthetic_gqa.py"
    subprocess.run([sys.executable, str(tool), "--out", str(tmp_path / "jax"),
                    *args], check=True, capture_output=True, timeout=120)
    write_synthetic_gqa(tmp_path / "port", 150, 30, 40, seed=9)
    files = [str(p.relative_to(tmp_path / "jax"))
             for p in (tmp_path / "jax").rglob("*.json")]
    assert len(files) == 4
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port",
                                           files, shallow=False)
    assert (mismatch, errors) == ([], [])


def test_synthetic_questions_for_the_scorer(synthetic):
    """The val split in the official questions format: its own answers
    score 100 %, and all attention on the first step's objects grounds."""
    path = write_scorer_questions(synthetic, "val_balanced")
    questions = json.loads(path.read_text())
    scenes = json.loads(
        (synthetic / "sceneGraphs" / "val_sceneGraphs.json").read_text())
    assert len(questions) == 64
    answers = {q: v["answer"] for q, v in questions.items()}
    atts = {}
    for q, v in questions.items():
        scene = scenes[v["imageId"]]
        gold = set(v["annotations"]["question"].values())
        atts[q] = [[o["x"] / scene["width"], o["y"] / scene["height"],
                    (o["x"] + o["w"]) / scene["width"],
                    (o["y"] + o["h"]) / scene["height"],
                    1.0 / len(gold) if oid in gold else 0.0]
                   for oid, o in sorted(scene["objects"].items())]
    scores = score_predictions(questions, answers, attentions=atts,
                               scenes=scenes)
    assert scores["accuracy"] == pytest.approx(100.0)
    assert scores["grounding"] > 50.0


@pytest.mark.parametrize("split", ["debug", "synthetic"])
def test_text_pipeline_matches_jax(split, debug_root, synthetic):
    """Tokenizer, lemmatizer and the program parser on every question, full
    answer and program of the split."""
    programs, _ = _split(split, debug_root, synthetic)
    data = json.loads(programs.read_text())
    texts = [d[1] for d in data] + [d[5] for d in data] + [
        "Can't you see the t-shirt? It's Tom's.", "CANNOT", "gonna", "(x)"]
    for text in texts:
        assert ptokenizer.tokenize(text) == jtokenizer.tokenize(text), text
    words = {w for t in texts for w in jtokenizer.tokenize(t)}
    words |= {"glasses", "leaves", "boxes", "potatoes", "berries", "bus"}
    for w in sorted(words):
        assert plemmatizer.lemmatize(w) == jlemmatizer.lemmatize(w), w
    lines = [f"[{i}]={d[9][0][0]}({', '.join(d[9][0][2:-1])})"
             for i, d in enumerate(data)]
    lines += ["exist([0])", "query_n()", "no_result(a, b )", "=f(x)"]
    for line in lines:
        assert (pconstants.parse_program(line)
                == jconstants.parse_program(line)), line
    assert pconstants.load_gqa_vocab_maps() == jconstants.load_gqa_vocab_maps()


@pytest.mark.parametrize("split", ["debug", "synthetic"])
def test_vocabularies_match_jax(split, debug_root, synthetic):
    """Scene-graph and text vocabularies, the answer maps, and encode /
    decode / decode_batch on the split's ids and on random ids."""
    programs, _ = _split(split, debug_root, synthetic)
    data = json.loads(programs.read_text())
    assert (pvocab.build_scene_graph_vocab().itos
            == jvocab.build_scene_graph_vocab().itos)
    assert pvocab.load_answer_maps() == jvocab.load_answer_maps()
    pv = pvocab.build_text_vocab(data, ptokenizer.tokenize)
    jv = jvocab.build_text_vocab(data, jtokenizer.tokenize)
    assert pv.itos == jv.itos
    for d in data:
        toks = ptokenizer.tokenize(d[1])
        np.testing.assert_array_equal(pv.encode(toks, 12), jv.encode(toks, 12))
        ids = [pv.lookup(t) for t in toks]
        np.testing.assert_array_equal(pv.encode_ids(ids, 9, False),
                                      jv.encode_ids(ids, 9, False))
    rng = np.random.default_rng(3)
    rows = rng.integers(-2, len(pv) + 3, size=(64, 14))
    rows[::3, 5] = 3                                 # <end> mid-row
    assert pv.decode_batch(rows) == jv.decode_batch(rows)
    assert [pv.decode(r) for r in rows] == [jv.decode(r) for r in rows]


@pytest.mark.parametrize("split", ["debug", "synthetic"])
def test_scene_graphs_and_bitmaps_match_jax(split, debug_root, synthetic):
    programs, scenes = _split(split, debug_root, synthetic)
    sg = json.loads(scenes.read_text())
    sg[""] = {}                                       # the dummy scene
    psv = pvocab.build_scene_graph_vocab()
    jsv = jvocab.build_scene_graph_vocab()
    for key, scene in sg.items():
        got = pscene.convert_scene_graph(scene, psv)
        want = jscene.convert_scene_graph(scene, jsv)
        for f in ("node_tokens", "edge_src", "edge_dst", "edge_tokens",
                  "edge_sym"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (key, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{key} {f}")
    for d in json.loads(programs.read_text()):
        n = len(sg[str(d[0])].get("objects", {})) or 2
        for steps in (5, 3):
            np.testing.assert_array_equal(
                pscene.build_execution_bitmap(n, d[8], steps),
                jscene.build_execution_bitmap(n, d[8], steps))


def _datasets(programs, scenes):
    """The same split as a JAX and a port GQADataset (same vocabularies)."""
    data = json.loads(pathlib.Path(programs).read_text())
    jtv = jvocab.build_text_vocab(data, jtokenizer.tokenize)
    ptv = pvocab.Vocab(jtv.itos)
    jds = jdataset.GQADataset(programs, scenes, jtv,
                              jvocab.build_scene_graph_vocab())
    pds = pdataset.GQADataset(programs, scenes, ptv,
                              pvocab.build_scene_graph_vocab())
    return jds, pds


def _assert_batches_equal(got, want):
    """A port QABatch (tensors) against a JAX one (numpy), byte for byte."""
    pairs = [("questions", got.questions, want.questions),
             ("programs", got.programs, want.programs),
             ("full_answers", got.full_answers, want.full_answers),
             ("short_answer_label", got.short_answer_label,
              want.short_answer_label)]
    for f in ("node_tokens", "node_graph", "node_mask", "edge_src",
              "edge_dst", "edge_tokens", "edge_mask", "edge_sym_sign",
              "exec_bitmap"):
        pairs.append((f, getattr(got.graphs, f), getattr(want.graphs, f)))
    for name, g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    for f in ("num_graphs", "nodes_per_graph", "edges_per_graph"):
        assert getattr(got.graphs, f) == getattr(want.graphs, f), f
    assert got.graphs.has_dense_layout == want.graphs.has_dense_layout


def _untimed(meta: dict) -> dict:
    return {k: v for k, v in meta.items() if k not in COLLATE_TIMING}


@pytest.mark.parametrize("workers", [0, 2])
def test_collate_time_in_the_meta(workers, synthetic):
    """Each batch's meta carries its collate's host-clock seconds and the
    process that ran it: this one with 0 workers, the pool's with 2."""
    import os
    _, pds = _datasets(*_split("synthetic", None, synthetic))
    pds.prewarm()
    bc = BatchConfig(num_graphs=32, nodes_per_graph=32, edges_per_graph=128)
    try:
        metas = [m for m, _ in pds.iter_batches(bc, num_workers=workers)]
    finally:
        pds.close()
    assert metas and all(m["collate_s"] > 0 for m in metas)
    pids = {m["collate_pid"] for m in metas}
    if workers:
        assert os.getpid() not in pids and 1 <= len(pids) <= workers
    else:
        assert pids == {os.getpid()}


@pytest.fixture
def numpy_packers(monkeypatch):
    """Both packages on their numpy packers (no native library)."""
    monkeypatch.setattr(pnative._State, "tried", True)
    monkeypatch.setattr(pnative._State, "lib", None)
    monkeypatch.setattr(jnative, "_LIB_TRIED", True)
    monkeypatch.setattr(jnative, "_LIB", None)


@pytest.mark.parametrize("packer", ["native", "numpy"])
@pytest.mark.parametrize("layout,npg,epg", [
    ("dense", 64, 256),        # the configured shape
    ("dense_bumped", 16, 32),  # 21 nodes, ~140 edges: a bigger rung
    ("flat_fallback", 2, 8),   # beyond 8x the configured padding
])
def test_collate_matches_jax(layout, npg, epg, packer, debug_root, request):
    """Every batch of the debug split, byte-equal, with equal layout counts."""
    if packer == "numpy":
        request.getfixturevalue("numpy_packers")
    elif shutil.which(pnative._CXX) is None:
        pytest.skip("no C++ compiler here: the native packer cannot build")
    else:
        assert pnative.native_available() and jnative.native_available()
    jds, pds = _datasets(*_split("debug", debug_root, None))
    kw = dict(num_graphs=4, nodes_pad=256, edges_pad=1024, layout="dense",
              nodes_per_graph=npg, edges_per_graph=epg)
    before = (dict(pdataset.collate_stats), dict(jdataset.collate_stats))
    got = list(pds.iter_batches(BatchConfig(**kw)))
    want = list(jds.iter_batches(JaxBatchConfig(**kw)))
    assert len(got) == len(want) == 2
    for (pm, pb), (jm, jb) in zip(got, want):
        assert _untimed(pm) == jm and pm["layout"] == layout
        _assert_batches_equal(pb, jb)
    deltas = [{k: s[k] - b[k] for k in s} for s, b in zip(
        (pdataset.collate_stats, jdataset.collate_stats), before)]
    assert deltas[0] == deltas[1] and deltas[0][layout] == 2


ORDERS = [
    dict(),
    dict(shuffle=True, seed=3),
    dict(shuffle=True, seed=4, drop_last=True),
    dict(shuffle=True, seed=1, size_bucket_windows=4),
    dict(shuffle=True, seed=2, size_bucket_windows=2, drop_last=True,
         permute_group=3),
    dict(shard_index=1, num_shards=3),
    dict(shuffle=True, seed=5, shard_index=0, num_shards=2, drop_last=True,
         size_bucket_windows=3),
]


@pytest.mark.parametrize("kw", ORDERS, ids=[str(i) for i in range(len(ORDERS))])
def test_batch_order_matches_jax(kw, synthetic):
    """Batch orders under shuffle, seeds, shards, size buckets and
    permute_group: the same question ids, batch by batch."""
    jds, pds = _datasets(*_split("synthetic", None, synthetic))
    got = [[int(i) for i in c] for c in pds.batch_order(BatchConfig(
        num_graphs=24), **kw)]
    bc = JaxBatchConfig(num_graphs=24, nodes_per_graph=128,
                        edges_per_graph=1024)
    want = [(m["question_ids"][:m["real_count"]], m["real_count"])
            for m, _ in jds.iter_batches(bc, **kw)]
    assert [(([pds.data[i][3] for i in c]), len(c)) for c in got] == want


def test_worker_pool_matches_in_process(synthetic):
    """num_workers=2 yields the in-process batches (metas and arrays),
    and the pool's layout outcomes reach this process's collate_stats."""
    _, pds = _datasets(*_split("synthetic", None, synthetic))
    pds.prewarm()
    bc = BatchConfig(num_graphs=32, nodes_per_graph=32, edges_per_graph=128)
    kw = dict(shuffle=True, seed=7, size_bucket_windows=2)
    want = list(pds.iter_batches(bc, **kw))
    before = dict(pdataset.collate_stats)
    try:
        got = list(pds.iter_batches(bc, num_workers=2, **kw))
    finally:
        pds.close()
    counted = {k: pdataset.collate_stats[k] - before[k] for k in before}
    assert sum(counted.values()) == len(want) == len(got)
    assert counted["dense_bumped"] == sum(
        m["layout"] == "dense_bumped" for m, _ in want) > 0
    for (gm, gb), (wm, wb) in zip(got, want):
        assert _untimed(gm) == _untimed(wm)
        assert gm["collate_pid"] != wm["collate_pid"]
        assert isinstance(gb.questions, torch.Tensor)
        for a, b in zip(dataclasses.astuple(gb.graphs),
                        dataclasses.astuple(wb.graphs)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
        assert torch.equal(gb.programs, wb.programs)


def test_glove_injection_matches_jax(tmp_path):
    """A fabricated GloVe file: the same matrices from both packages, and
    the port's injected embeddings equal JAX's injected parameters."""
    cfg = tiny_model_config()
    words = ["<unk>", "<pad>", "the", "red", "cat"] + [
        f"w{i}" for i in range(cfg.text.vocab_size - 5)]
    rng = np.random.default_rng(0)
    with open(tmp_path / "glove.txt", "w") as f:
        for w in words[2:] + ["absent"]:
            if w != "w7":
                vec = rng.normal(size=cfg.text.emb_dim)
                f.write(w + " " + " ".join(f"{v:.5f}" for v in vec) + "\n")
    pv, jv = pvocab.Vocab(words), jvocab.Vocab(words)
    text = pvocab.load_glove_matrix(pv, tmp_path / "glove.txt",
                                    dim=cfg.text.emb_dim)
    np.testing.assert_array_equal(text, jvocab.load_glove_matrix(
        jv, tmp_path / "glove.txt", dim=cfg.text.emb_dim))
    assert not text[words.index("w7")].any() and text[2].any()
    sg = rng.normal(size=(cfg.scene.vocab_size, cfg.scene.emb_dim)).astype(
        np.float32)
    variables = jax_variables(cfg, seed=4)
    want = from_jax_variables(jax_inject(variables, text, sg))
    model = inject_pretrained_embeddings(port_model(cfg, variables), text, sg)
    got = model.state_dict()
    for name in ("text_vocab_embedding.weight",
                 "scene_graph_encoder.sg_vocab_embedding.weight"):
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())
    with pytest.raises(FileNotFoundError):
        pvocab.load_glove_matrix(pv, tmp_path / "missing.txt")
