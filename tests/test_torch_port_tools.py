"""The port's host tools against the JAX package's, on the CPU: the GQA
preprocessor, the tokenizer audit (and the preprocess CLI's
``--audit-tokens``), the torchtext-free vocabulary import, the checkpoint
converter and the visualizers. Outputs are compared exactly: byte for byte
(files) or equal (reports, logits)."""
import dataclasses
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from graphvqa_tpu.cli import preprocess_cli as jax_preprocess_cli
from graphvqa_tpu.cli.convert_ckpt_cli import (
    get_args_parser as jax_convert_parser, main as jax_convert_main)
from graphvqa_tpu.data import preprocess as jax_preprocess
from graphvqa_tpu.data import token_audit as jax_token_audit
from graphvqa_tpu.data import torchtext_import as jax_torchtext_import
from graphvqa_tpu_torch.cli import preprocess_cli
from graphvqa_tpu_torch.cli.convert_ckpt_cli import (
    get_args_parser as convert_parser, main as convert_main)
from graphvqa_tpu_torch.cli.train_cli import (
    build_config, get_args_parser as train_parser, main as train_main)
from graphvqa_tpu_torch.data import (
    GQADataset, build_scene_graph_vocab, build_text_vocab, preprocess,
    token_audit, tokenize, torchtext_import)
from graphvqa_tpu_torch.data.vocab import load_answer_maps
from graphvqa_tpu_torch.eval import visualize
from graphvqa_tpu_torch.models.pipeline import build_model
from graphvqa_tpu_torch.train.checkpoint import restore_checkpoint
from graphvqa_tpu_torch.train.loop import make_eval_step, validate
from graphvqa_tpu_torch.train.train_state import create_train_state
from tests.test_torchtext_import import REF_ITOS, _fake_torchtext_pickle

ASSETS = (pathlib.Path(__file__).resolve().parent.parent
          / "graphvqa_tpu_torch" / "assets" / "debug")


def test_preprocess_output_is_byte_equal_to_jax(tmp_path):
    for mod, name in ((jax_preprocess, "jax.json"), (preprocess, "port.json")):
        mod.preprocess_file(ASSETS / "debug_questions.json", tmp_path / name,
                            ASSETS / "debug_sceneGraphs.json", seed=0)
    port = (tmp_path / "port.json").read_bytes()
    assert port == (tmp_path / "jax.json").read_bytes()
    assert len(json.loads(port)) == 7


@pytest.mark.parametrize("source", ["debug_questions.json",
                                    "debug_programs.json"])
def test_token_audit_report_equals_jax(source, tmp_path):
    vocab = build_text_vocab(
        json.loads((ASSETS / "debug_programs.json").read_text()), tokenize)
    vocab.save(tmp_path / "text_vocab.json")
    got = token_audit.audit_file(ASSETS / source, tmp_path / "text_vocab.json")
    want = jax_token_audit.audit_file(ASSETS / source,
                                      tmp_path / "text_vocab.json")
    assert got == want
    assert token_audit.format_report(got) == jax_token_audit.format_report(
        want)


def test_preprocess_cli_audit_tokens_prints_jax_report(monkeypatch, capsys):
    argv = ["preprocess_cli", "--audit-tokens",
            str(ASSETS / "debug_questions.json")]
    outputs = []
    for cli in (jax_preprocess_cli, preprocess_cli):
        monkeypatch.setattr(sys, "argv", argv)
        cli.main()
        outputs.append(capsys.readouterr().out)
    assert outputs[1] == outputs[0] and outputs[1].startswith("texts: ")


@pytest.mark.parametrize("with_vectors", [True, False])
def test_torchtext_import_equals_jax(with_vectors, tmp_path):
    pkl = tmp_path / "GQA_TEXT_obj.pkl"
    pkl.write_bytes(_fake_torchtext_pickle(REF_ITOS,
                                           with_vectors=with_vectors))
    itos, vectors = torchtext_import.load_torchtext_field(pkl)
    assert itos == REF_ITOS
    assert (vectors is None) == (not with_vectors)
    results = {}
    for mod, name in ((jax_torchtext_import, "jax"),
                      (torchtext_import, "port")):
        d = tmp_path / name
        d.mkdir()
        results[name] = mod.import_reference_vocab(
            pkl, d / "text_vocab.json", d / "glove_text.npy")
    assert results["port"] == results["jax"] == (len(REF_ITOS), with_vectors)
    for f in ("text_vocab.json",) + (("glove_text.npy",) if with_vectors
                                     else ()):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


def test_convert_cli_vocab_alone_equals_jax(tmp_path):
    pkl = tmp_path / "GQA_TEXT_obj.pkl"
    pkl.write_bytes(_fake_torchtext_pickle(REF_ITOS))
    for parser, main, name in ((jax_convert_parser, jax_convert_main, "jax"),
                               (convert_parser, convert_main, "port")):
        main(parser().parse_args([
            "--torch-vocab", str(pkl),
            "--vocab-out", str(tmp_path / name / "text_vocab.json")]))
    for f in ("text_vocab.json", "glove_text.npy"):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


def _debug_root(tmp_path):
    root = tmp_path / "data"
    (root / "questions").mkdir(parents=True)
    (root / "sceneGraphs").mkdir()
    shutil.copy(ASSETS / "debug_programs.json", root / "questions")
    shutil.copy(ASSETS / "debug_sceneGraphs.json",
                root / "sceneGraphs" / "val_sceneGraphs.json")
    return root


def test_converted_checkpoint_resumes_with_the_saved_logits(tmp_path):
    """A reference-format ``torch.save({'model': state_dict})`` of a seeded
    tiny model (DDP's ``module.`` prefix on its keys) goes through the
    converter; ``--resume`` then restores the very weights (equal logits)
    and ``--resume --evaluate`` dumps the saved model's predictions."""
    root, out = _debug_root(tmp_path), tmp_path / "out"
    flags = ["--tiny", "--device", "cpu", "--data-root", str(root),
             "--split", "debug", "--val-split", "debug", "--batch-size", "4",
             "--rounds", "2", "--output_dir", str(out)]
    args = train_parser().parse_args(flags)
    text_vocab = build_text_vocab(json.loads(
        (root / "questions" / "debug_programs.json").read_text()), tokenize)
    sg_vocab = build_scene_graph_vocab()
    cfg = build_config(args, len(text_vocab), len(sg_vocab))
    model = build_model(cfg.model, device="cpu", seed=5)
    torch.save({"model": {"module." + k: v
                          for k, v in model.state_dict().items()},
                "epoch": 3}, tmp_path / "reference.pth")

    ckpt = out / "ckpt_converted"
    convert_main(convert_parser().parse_args([
        "--torch-ckpt", str(tmp_path / "reference.pth"), "--out", str(ckpt),
        "--model", "gat", "--num-encoder-layers", "2",
        "--num-decoder-layers", "2", "--num-rounds", "2"]))
    fresh = build_model(cfg.model, device="cpu", seed=99)
    state, start = restore_checkpoint(ckpt, create_train_state(fresh))
    assert (state.epoch, start) == (3, 4)
    ds = GQADataset(root / "questions" / "debug_programs.json",
                    root / "sceneGraphs" / "val_sceneGraphs.json",
                    text_vocab, sg_vocab)
    batches = list(ds.iter_batches(cfg.batch))
    with torch.inference_mode():
        for _, b in batches:
            want = model.sample(b).short_answer_logits
            got = fresh.sample(b).short_answer_logits
            assert torch.equal(got, want)

    validate(make_eval_step(model, cfg), batches, cfg, text_vocab=text_vocab,
             label2ans=load_answer_maps()[1],
             dump_path=str(tmp_path / "want.json"))
    train_main(train_parser().parse_args(
        flags + ["--evaluate", "--resume", str(ckpt), "--dump-result"]))
    got = json.loads((out / "dump_results.json").read_text())
    assert got == json.loads((tmp_path / "want.json").read_text())
    assert len(got) == 7


@pytest.mark.parametrize("family,engine", [("gat", False), ("gat", True),
                                           ("lcgn", False)])
def test_converter_reads_the_model_from_the_checkpoint(family, engine):
    """The converter's model config takes the widths, the vocabulary sizes
    and the execution engine from the checkpoint's tensors: a --tiny model
    (not the configuration's widths) loads without a flag for them."""
    from graphvqa_tpu_torch.cli.convert_ckpt_cli import model_config
    args = train_parser().parse_args(
        ["--model", family, "--tiny", "--rounds", "2", "--data-root", "."]
        + (["--use-execution-engine"] if engine else []))
    want = build_config(args, 40, 30).model
    sd = build_model(want, device="cpu", seed=0).state_dict()
    got = model_config(convert_parser().parse_args(
        ["--model", family, "--num-encoder-layers", "2",
         "--num-rounds", "2"]), sd)
    # the heads are in no tensor's shape: the configuration's stay
    assert got == dataclasses.replace(want, transformer=dataclasses.replace(
        want.transformer, num_heads=got.transformer.num_heads))
    build_model(got, device="cpu", seed=0).load_state_dict(sd)


def test_visualizers_write_images(tmp_path):
    from PIL import Image
    image = np.random.default_rng(0).integers(0, 255, (40, 60, 3), np.uint8)
    rows = [[0.1, 0.1, 0.5, 0.6, 0.7], [0.4, 0.2, 0.9, 0.9, 0.3]]
    calls = {"box.png": lambda p: visualize.show_box(image, 5, 5, 20, 10,
                                                      "box", save_path=p),
             "boxes.png": lambda p: visualize.show_boxes(
                 image, [r[:4] for r in rows], save_path=p),
             "attention.png": lambda p: visualize.show_attention(
                 image, rows, "att", save_path=p)}
    for name, call in calls.items():
        assert call(tmp_path / name) is None
        with Image.open(tmp_path / name) as im:
            assert im.size[0] > 0 and im.size[1] > 0


def test_every_port_module_imports_without_jax(tmp_path):
    """Every module of graphvqa_tpu_torch (the host tools and the parallel
    package among them) imports with jax, flax and the JAX package
    blocked."""
    import subprocess
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "graphvqa_tpu"):
    sys.modules[name] = None
import graphvqa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(graphvqa_tpu_torch.__path__,
                                               "graphvqa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), "modules")
"""
    repo = pathlib.Path(__file__).resolve().parent.parent
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={"PYTHONPATH": str(repo), "PATH": "/usr/bin"},
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert int(run.stdout.split()[0]) >= 45
