"""The port's flat layout, its K-step train call, validate with its dumps,
the scorer and the train CLI, against the JAX package on the CPU.

Tolerances (float32, dropout 0 wherever JAX is compared):
  * segment ops and the flat graph LayerNorm: rtol/atol 1e-5, their
    gradients too (jax.vjp against torch.autograd);
  * a flat batch through the whole model: logits within 1e-5, equal greedy
    tokens; one flat train step as tests/test_torch_port_train.py holds the
    dense one (loss and metrics rtol 1e-5, gradients 1e-5 of each tensor's
    scale plus 5e-8, updated parameters 1e-6 where |grad| > 1e-6, running
    statistics 1e-5);
  * two steps in one call: bit for bit the two single steps of the port, and
    JAX's ``lax.scan`` dispatch to rtol 1e-5 on the reduced metrics and the
    running statistics (running means 0.1 x 2 lr more: the momentum times
    the bound on an ill-conditioned first step of the bias before them),
    1e-6 on parameters whose |grad| > 1e-6 at both steps (the single step's
    bound, per step), 2 lr per step elsewhere;
  * validate on the debug fixture: equal strings in the result dump,
    ``prediction_score`` within 0.01, attention values within 1e-5, and the
    same scorer report from both packages' scorers.
The CLI runs in subprocesses with jax, flax and graphvqa_tpu blocked.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvqa_tpu.config as jcfg
import graphvqa_tpu.data.dataset as jdataset
import graphvqa_tpu_torch.config as pcfg
import graphvqa_tpu_torch.data.dataset as pdataset
from graphvqa_tpu.eval import scorer as jscorer
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.ops import layernorm as jlayernorm
from graphvqa_tpu.ops import segment as jsegment
from graphvqa_tpu.parallel.data_parallel import stack_shards
from graphvqa_tpu.train.loop import make_eval_step as jax_make_eval_step
from graphvqa_tpu.train.loop import make_train_step as jax_make_train_step
from graphvqa_tpu.train.loop import validate as jax_validate
from graphvqa_tpu.train.train_state import (
    create_train_state as jax_create_train_state)
from graphvqa_tpu.data import vocab as jvocab
from graphvqa_tpu_torch.cli.train_cli import build_config, get_args_parser
from graphvqa_tpu_torch.cli.train_cli import main as cli_main
from graphvqa_tpu_torch.data import vocab as pvocab
from graphvqa_tpu_torch.eval import scorer as pscorer
from graphvqa_tpu_torch.models.convert import from_jax_variables
from graphvqa_tpu_torch.ops import layernorm as playernorm
from graphvqa_tpu_torch.ops import segment as psegment
from graphvqa_tpu_torch.train.loop import (
    make_eval_step, make_train_step, train_one_epoch)
from graphvqa_tpu_torch.train.loop import validate
from graphvqa_tpu_torch.train.metrics import reduce_scanned_metrics
from graphvqa_tpu_torch.train.train_state import create_train_state
from tests.test_torch_port_train import LR, WD, _jax_step, _no_dropout
from tests.torch_port_helpers import (
    jax_variables, port_batch, port_model, port_model_config,
    random_qa_batch, tiny_model_config)

REPO = pathlib.Path(__file__).resolve().parent.parent
DEBUG = REPO / "graphvqa_tpu_torch" / "assets" / "debug"
TOL = dict(rtol=1e-5, atol=1e-5)
# jax, flax and the JAX package made unimportable, then the script
BAN = """import sys
for name in ("jax", "jaxlib", "flax", "graphvqa_tpu"):
    sys.modules[name] = None
"""


# --- segment ops and the flat LayerNorm -------------------------------------

def _segments(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, 6, size=40)).astype(np.int32)
    ids[-5:] = 7                                   # segment 6 stays empty
    mask = rng.random(40) > 0.2
    mask[-5:] = False
    vals = rng.normal(size=(40, 3)).astype(np.float32)
    vals[3] = vals[2]                              # a tie at a segment max
    return ids, mask, vals


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max",
                                "segment_softmax"])
def test_segment_ops_and_gradients_match_jax(op):
    ids, mask, vals = _segments()
    cot = np.random.default_rng(1).normal(size=(8, 3) if op != "segment_softmax"
                                          else (40, 3)).astype(np.float32)
    jfn = getattr(jsegment, op)
    want, vjp = jax.vjp(lambda v: jfn(v, jnp.asarray(ids), 8,
                                      mask=jnp.asarray(mask)), jnp.asarray(vals))
    x = torch.from_numpy(vals).requires_grad_(True)
    got = getattr(psegment, op)(x, torch.from_numpy(ids), 8,
                                mask=torch.from_numpy(mask))
    finite = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(got.detach().numpy()[finite],
                               np.asarray(want)[finite], **TOL)
    assert (np.isfinite(got.detach().numpy()) == finite).all()
    if op == "segment_max":
        cot = np.where(finite, cot, 0.0).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(cot)[0]), **TOL)
    assert torch.isfinite(x.grad).all()


def test_flat_graph_layer_norm_matches_jax():
    ids, mask, vals = _segments(2)
    node_graph = np.where(mask, np.minimum(ids, 5), 6).astype(np.int32)
    w, b = np.array([1.3], np.float32), np.array([-0.2], np.float32)
    want, vjp = jax.vjp(
        lambda v: jlayernorm.graph_layer_norm(
            v, jnp.asarray(node_graph), 6, jnp.asarray(w), jnp.asarray(b),
            node_mask=jnp.asarray(mask)), jnp.asarray(vals))
    x = torch.from_numpy(vals).requires_grad_(True)
    got = playernorm.graph_layer_norm(
        x, torch.from_numpy(node_graph), 6, torch.from_numpy(w),
        torch.from_numpy(b), node_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    cot = np.random.default_rng(3).normal(size=vals.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(cot)[0]), **TOL)


# --- a flat batch through the whole model -----------------------------------

@pytest.fixture(scope="module")
def flat_case():
    cfg = _no_dropout(tiny_model_config())
    variables = jax_variables(cfg, seed=2)
    jb = random_qa_batch(seed=5, num_graphs=4, cfg=cfg, dense=False,
                         nodes_pad=40, edges_pad=72)
    assert not jb.graphs.has_dense_layout
    return cfg, variables, jb


def test_flat_batch_eval_matches_jax(flat_case):
    cfg, variables, jb = flat_case
    model_in = jb.replace(programs=jb.programs[:, :-1],
                          full_answers=jb.full_answers[:, :-1])
    want = JaxPipelineModel(cfg).apply(
        jax.tree.map(jnp.asarray, variables), model_in, sample=True,
        deterministic=True, use_running_average=True)
    pb = port_batch(jb)
    assert not pb.graphs.has_dense_layout
    got = port_model(cfg, variables).sample(dataclasses.replace(
        pb, programs=pb.programs[:, :-1], full_answers=pb.full_answers[:, :-1]))
    np.testing.assert_allclose(got.short_answer_logits.numpy(),
                               np.asarray(want.short_answer_logits), **TOL)
    np.testing.assert_array_equal(got.program_tokens.numpy(),
                                  np.asarray(want.program_tokens))
    np.testing.assert_array_equal(got.full_answer_tokens.numpy(),
                                  np.asarray(want.full_answer_tokens))
    mask = np.asarray(jb.graphs.node_mask)
    np.testing.assert_allclose(got.node_attention.numpy()[mask],
                               np.asarray(want.node_attention)[mask], **TOL)


def test_flat_batch_train_step_matches_jax(flat_case):
    cfg, variables, jb = flat_case
    grads, new, jm = _jax_step(cfg, variables, jb,
                               jcfg.TrainConfig(lr=LR, weight_decay=WD))
    model = port_model(cfg, variables)
    step = make_train_step(model, pcfg.Config(
        model=port_model_config(cfg),
        train=pcfg.TrainConfig(lr=LR, weight_decay=WD)))
    _, m = step(create_train_state(model, lr=LR, weight_decay=WD),
                port_batch(jb), torch.Generator().manual_seed(0))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want_g = from_jax_variables({"params": jax.device_get(grads),
                                 "batch_stats": variables["batch_stats"]})
    want = from_jax_variables({"params": jax.device_get(new.params),
                               "batch_stats": jax.device_get(new.batch_stats)})
    sd = model.state_dict()
    for name, p in model.named_parameters():
        w = want_g[name].numpy()
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max() + 5e-8,
                                   err_msg=name)
        ok = np.abs(w) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[ok],
                                   want[name].numpy()[ok], rtol=0, atol=1e-6,
                                   err_msg=name)
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), want[name].numpy(),
                                       err_msg=name, **TOL)


# --- K steps in one call ----------------------------------------------------

def _two_batches(cfg):
    return [random_qa_batch(seed=s, num_graphs=3, cfg=cfg, dense=True)
            for s in (11, 12)]


def test_two_steps_in_one_call_equal_two_single_steps():
    """Dropout on: one call of K=2 and two single calls, the same generator
    seed, give the same parameters, statistics and (reduced) metrics bit for
    bit."""
    cfg = tiny_model_config()
    batches = [port_batch(b) for b in _two_batches(cfg)]
    pc = pcfg.Config(model=port_model_config(cfg),
                     train=pcfg.TrainConfig(lr=LR, weight_decay=WD))
    variables = jax_variables(cfg, seed=6)
    runs = []
    for k in (1, 2):
        model = port_model(cfg, variables)
        state = create_train_state(model, lr=LR, weight_decay=WD)
        step = make_train_step(model, pc, steps_per_dispatch=k)
        gen = torch.Generator().manual_seed(3)
        if k == 2:
            state, m = step(state, batches, gen)
        else:
            per = [step(state, b, gen)[1] for b in batches]
            m = reduce_scanned_metrics({key: [p[key] for p in per]
                                        for key in per[0]})
        runs.append((m, {k2: v.clone() for k2, v in model.state_dict().items()},
                     state.step))
    (m1, sd1, s1), (m2, sd2, s2) = runs
    assert s1 == s2 == 2
    for key in sd1:
        assert torch.equal(sd1[key], sd2[key]), key
    assert set(m1) == set(m2)
    for key in m1:
        assert float(m1[key]) == float(m2[key]), key
    with pytest.raises(ValueError, match="expected 2 batches"):
        make_train_step(port_model(cfg, variables), pc, 2)(
            create_train_state(port_model(cfg, variables)), batches[:1],
            torch.Generator())


def test_two_steps_in_one_call_match_jax_scan_dispatch():
    cfg = _no_dropout(tiny_model_config())
    jbs = _two_batches(cfg)
    variables = jax_variables(cfg, seed=7)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, variables),
                                    lr=LR, weight_decay=WD)
    new, jm = jax_make_train_step(
        JaxPipelineModel(cfg), jcfg.Config(model=cfg, train=jcfg.TrainConfig(
            lr=LR, weight_decay=WD)), steps_per_dispatch=2)(
        jstate, stack_shards(jbs), jax.random.key(0))
    model = port_model(cfg, variables)
    step = make_train_step(model, pcfg.Config(
        model=port_model_config(cfg),
        train=pcfg.TrainConfig(lr=LR, weight_decay=WD)), steps_per_dispatch=2)
    state, m = step(create_train_state(model, lr=LR, weight_decay=WD),
                    [port_batch(b) for b in jbs], torch.Generator())
    assert state.step == int(new.step) == 2
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = from_jax_variables({"params": jax.device_get(new.params),
                               "batch_stats": jax.device_get(new.batch_stats)})
    # the first step's gradients, from a single step of another copy
    first = port_model(cfg, variables)
    make_train_step(first, pcfg.Config(model=port_model_config(cfg)))(
        create_train_state(first), port_batch(jbs[0]), torch.Generator())
    g1 = {n: p.grad for n, p in first.named_parameters()}
    sd = model.state_dict()
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        if p.grad is not None and g1[name] is not None:
            ok = ((p.grad.abs() > 1e-6) & (g1[name].abs() > 1e-6)).numpy()
            np.testing.assert_allclose(got[ok], w[ok], rtol=0, atol=1e-6,
                                       err_msg=name)
        assert np.abs(got - w).max() <= 4 * LR, name
    # a running mean moves with the bias in front of its BatchNorm, whose
    # gradient is 0 in exact arithmetic: its first Adam step is round-off
    # over eps, within 2 lr, and the second step's batch mean carries it
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            shift = 0.1 * 2 * LR if name.endswith("running_mean") else 0.0
            np.testing.assert_allclose(sd[name].numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-5 + shift,
                                       err_msg=name)


def test_train_one_epoch_traces_its_profile_window(tmp_path):
    """profile_dir: a Chrome trace of steps [1, 3) of the epoch."""
    cfg = tiny_model_config()
    batches = [(None, port_batch(b)) for b in _two_batches(cfg) * 2]
    model = port_model(cfg, jax_variables(cfg, seed=9))
    step = make_train_step(model, pcfg.Config(model=port_model_config(cfg)))
    state = train_one_epoch(step, create_train_state(model), batches,
                            torch.Generator().manual_seed(0), 0,
                            profile_dir=str(tmp_path / "trace"),
                            profile_steps=(1, 3))
    assert state.step == 4
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("aten::" in ev.get("name", "")
               for ev in trace["traceEvents"])


# --- validate, its dumps and the scorer ------------------------------------

def _debug_root(tmp_path):
    root = tmp_path / "data"
    (root / "questions").mkdir(parents=True)
    (root / "sceneGraphs").mkdir()
    (root / "questions" / "debug_programs.json").write_bytes(
        (DEBUG / "debug_programs.json").read_bytes())
    (root / "sceneGraphs" / "val_sceneGraphs.json").write_bytes(
        (DEBUG / "debug_sceneGraphs.json").read_bytes())
    return root


def _jax_model_config(mc: pcfg.ModelConfig) -> jcfg.ModelConfig:
    f = dataclasses.asdict(mc)
    for name, cls in (("text", jcfg.TextConfig),
                      ("scene", jcfg.SceneGraphConfig),
                      ("transformer", jcfg.TransformerConfig),
                      ("engine", jcfg.EngineConfig)):
        f[name] = cls(**f[name])
    return jcfg.ModelConfig(**f)


def test_validate_dumps_and_scorer_match_jax(tmp_path):
    """--tiny in float32 on the debug fixture (B=4: a full batch and a
    ragged one), the same weights through both packages' validate."""
    root = _debug_root(tmp_path)
    data = json.loads((root / "questions" / "debug_programs.json").read_text())
    jtv = jvocab.build_text_vocab(data, __import__(
        "graphvqa_tpu.data.tokenizer", fromlist=["tokenize"]).tokenize)
    ptv = pvocab.Vocab(jtv.itos)
    args = get_args_parser().parse_args([
        "--data-root", str(root), "--tiny", "--dtype", "float32",
        "--batch-size", "4"])
    pc = build_config(args, len(ptv), len(pvocab.build_scene_graph_vocab()))
    jc = jcfg.Config(model=_jax_model_config(pc.model),
                     batch=jcfg.BatchConfig(**dataclasses.asdict(pc.batch)))
    variables = jax_variables(jc.model, seed=8)
    programs = root / "questions" / "debug_programs.json"
    scenes = root / "sceneGraphs" / "val_sceneGraphs.json"
    pds = pdataset.GQADataset(programs, scenes, ptv,
                              pvocab.build_scene_graph_vocab())
    jds = jdataset.GQADataset(programs, scenes, jtv,
                              jvocab.build_scene_graph_vocab())
    _, label2ans = pvocab.load_answer_maps()
    out = {}
    for side in ("port", "jax"):
        kw = dict(text_vocab=ptv if side == "port" else jtv,
                  label2ans=label2ans,
                  dump_path=str(tmp_path / side / "dump_results.json"),
                  dump_attentions_path=str(tmp_path / side /
                                           "dump_attentions.json"),
                  print_qualitative=True)
        if side == "port":
            res = validate(make_eval_step(port_model(jc.model, variables), pc),
                           pds.iter_batches(pc.batch), pc,
                           scenes=pds.sg_data, **kw)
        else:
            res = jax_validate(
                jax_make_eval_step(JaxPipelineModel(jc.model), jc),
                jax_create_train_state(jax.tree.map(jnp.asarray, variables)),
                jds.iter_batches(jc.batch), jax.random.key(0), jc,
                scenes=jds.sg_data, **kw)
        out[side] = (res, json.loads((tmp_path / side /
                                      "dump_results.json").read_text()),
                     json.loads((tmp_path / side /
                                 "dump_attentions.json").read_text()))
    (pres, pdump, patt), (jres, jdump, jatt) = out["port"], out["jax"]
    assert pres == pytest.approx(jres)
    assert set(pdump) == set(jdump) and len(pdump) == len(data)
    for qid, row in jdump.items():
        got = dict(pdump[qid])
        assert abs(float(got.pop("prediction_score"))
                   - float(row["prediction_score"])) <= 0.01, qid
        assert got == {k: v for k, v in row.items()
                       if k != "prediction_score"}, qid
    assert [a["questionId"] for a in patt] == [a["questionId"] for a in jatt]
    for a, b in zip(patt, jatt):
        np.testing.assert_allclose(np.asarray(a["attention"]),
                                   np.asarray(b["attention"]), rtol=0,
                                   atol=1e-5)
    # both scorers on the port's dumps: the same report
    questions = json.loads((DEBUG / "debug_questions.json").read_text())
    sg = json.loads((DEBUG / "debug_sceneGraphs.json").read_text())
    preds = {q: r["prediction"] for q, r in pdump.items()}
    atts = {a["questionId"]: a["attention"] for a in patt}
    reports = [s.format_report(s.score_predictions(
        questions, preds, consistency=True, attentions=atts, scenes=sg),
        consistency=True, grounding=True) for s in (pscorer, jscorer)]
    assert reports[0] == reports[1]


# --- the train CLI ----------------------------------------------------------

def _run_banned(script, timeout=300):
    """Run ``script`` in a subprocess where jax, flax and graphvqa_tpu cannot
    be imported (at most 4 threads)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4")
    proc = subprocess.run([sys.executable, "-c", BAN + script], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _cli_script(root, out, runs, score=True):
    """Calls of the port's CLI main with ``runs`` (argument lists), then the
    port's scorer over the dumps."""
    lines = ["from graphvqa_tpu_torch.cli.train_cli import "
             "get_args_parser, main",
             "p = get_args_parser()"]
    lines += [f"main(p.parse_args({run!r}))" for run in runs]
    if score:
        lines += [
            "import json",
            "from graphvqa_tpu_torch.eval.scorer import "
            "score_predictions, format_report",
            f"qs = json.load(open({str(DEBUG / 'debug_questions.json')!r}))",
            f"sg = json.load(open({str(DEBUG / 'debug_sceneGraphs.json')!r}))",
            f"dump = json.load(open({str(out / 'dump_results.json')!r}))",
            f"att = json.load(open({str(out / 'dump_attentions.json')!r}))",
            "s = score_predictions(qs, {q: r['prediction'] for q, r in "
            "dump.items()}, attentions={a['questionId']: a['attention'] "
            "for a in att}, scenes=sg)",
            "print(format_report(s, grounding=True))",
            "print('ACCURACY', s['accuracy'])"]
    return "\n".join(lines) + "\n"


def test_cli_trains_checkpoints_resumes_evaluates_and_scores(tmp_path):
    root, out = _debug_root(tmp_path), tmp_path / "out"
    common = ["--tiny", "--device", "cpu", "--data-root", str(root),
              "--split", "debug", "--val-split", "debug", "--batch-size", "4",
              "--print-freq", "1", "--output_dir", str(out)]
    stdout = _run_banned(_cli_script(root, out, [
        common + ["--epochs", "2", "--validate-every", "1",
                  "--fast-validate", "1", "--workers", "2"],
        common + ["--epochs", "3", "--resume", str(out / "ckpt"),
                  "--prng", "threefry"],
        common + ["--evaluate", "--dump-result", "--dump-attentions",
                  "--resume", str(out / "ckpt")]]))
    assert re.search(r"^collate packer: (native \(.+\)|numpy)$", stdout,
                     re.M)
    assert "resumed from" in stdout and "at epoch 2" in stdout
    assert "--prng names JAX machinery and does nothing here" in stdout
    assert "Result Dumped!" in stdout and "Attentions Dumped!" in stdout
    assert "Accuracy:" in stdout and "Grounding:" in stdout
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == [
        "ckpt_0.pt", "ckpt_1.pt", "ckpt_2.pt"]
    assert (out / "log-gat.txt").stat().st_size > 0
    assert json.loads((out / "text_vocab.json").read_text())["itos"]
    dump = json.loads((out / "dump_results.json").read_text())
    assert len(dump) == 7


@pytest.mark.parametrize("flags,item", [
    (["--data-parallel", "2"], "item 6"), (["--edge-parallel", "2"], "item 6"),
    (["--model", "lcgn", "--data-parallel", "2"], "item 6")])
def test_cli_names_the_roadmap_item_of_unported_flags(flags, item, tmp_path):
    args = get_args_parser().parse_args(
        ["--data-root", str(tmp_path), "--device", "cpu"] + flags)
    with pytest.raises(SystemExit, match=item):
        cli_main(args)


@pytest.mark.parametrize("flags", [
    ["--model", "gcn"], ["--model", "gine"], ["--model", "lcgn"],
    ["--model", "onlysg"], ["--model", "gat", "--use-execution-engine"]],
    ids=["gcn", "gine", "lcgn", "onlysg", "gat-exec"])
def test_cli_trains_and_evaluates_every_family(flags, tmp_path):
    """One tiny epoch with a validation, then --resume --evaluate with the
    dumps, for each family and the execution engine; no exit."""
    root, out = _debug_root(tmp_path), tmp_path / "out"
    common = ["--tiny", "--device", "cpu", "--data-root", str(root),
              "--split", "debug", "--val-split", "debug", "--batch-size", "4",
              "--print-freq", "1", "--output_dir", str(out)] + flags
    stdout = _run_banned(_cli_script(root, out, [
        common + ["--epochs", "1", "--validate-every", "1"],
        common + ["--evaluate", "--dump-result", "--dump-attentions",
                  "--resume", str(out / "ckpt")]]))
    assert "resumed from" in stdout and "Result Dumped!" in stdout
    assert "Accuracy:" in stdout
    losses = [float(v) for v in re.findall(r"Loss (\S+) \(", stdout)]
    assert losses and all(np.isfinite(losses))
    with_bitmap = "--use-execution-engine" in flags
    assert ("'bitmap_precision'" in stdout) == with_bitmap
    name = flags[1]
    assert (out / f"log-{name}.txt").stat().st_size > 0
    ckpt = torch.load(out / "ckpt" / "ckpt_0.pt", weights_only=True)
    engine = {"onlysg": "gat_seq"}.get(name, f"{name}_seq")
    assert any(k.startswith(engine + ".") for k in ckpt["params"])
    assert any(k.startswith("execution_engine.")
               for k in ckpt["params"]) == with_bitmap


def test_validate_bitmap_meters_match_jax(tmp_path):
    """--use-execution-engine: validate's bitmap precision and recall over
    the real graphs' nodes equal JAX validate's on the same batches (B=4:
    a full batch and a ragged one)."""
    root = _debug_root(tmp_path)
    data = json.loads((root / "questions" / "debug_programs.json").read_text())
    jtv = jvocab.build_text_vocab(data, __import__(
        "graphvqa_tpu.data.tokenizer", fromlist=["tokenize"]).tokenize)
    ptv = pvocab.Vocab(jtv.itos)
    args = get_args_parser().parse_args([
        "--data-root", str(root), "--tiny", "--dtype", "float32",
        "--batch-size", "4", "--use-execution-engine"])
    pc = build_config(args, len(ptv), len(pvocab.build_scene_graph_vocab()))
    assert pc.model.use_execution_engine and pc.train.use_bitmap_loss
    jc = jcfg.Config(model=_jax_model_config(pc.model),
                     batch=jcfg.BatchConfig(**dataclasses.asdict(pc.batch)))
    variables = jax_variables(jc.model, seed=9)
    # a peaked gate, so that some nodes pass the 0.5 threshold
    gate = variables["params"]["execution_engine"]["bitmap_gate_mlp"]
    gate["lin2"]["kernel"] = gate["lin2"]["kernel"] * 40.0
    programs = root / "questions" / "debug_programs.json"
    scenes = root / "sceneGraphs" / "val_sceneGraphs.json"
    pds = pdataset.GQADataset(programs, scenes, ptv,
                              pvocab.build_scene_graph_vocab())
    jds = jdataset.GQADataset(programs, scenes, jtv,
                              jvocab.build_scene_graph_vocab())
    pres = validate(make_eval_step(port_model(jc.model, variables), pc),
                    pds.iter_batches(pc.batch), pc)
    jres = jax_validate(
        jax_make_eval_step(JaxPipelineModel(jc.model), jc),
        jax_create_train_state(jax.tree.map(jnp.asarray, variables)),
        jds.iter_batches(jc.batch), jax.random.key(0), jc)
    assert "bitmap_precision" in jres and "bitmap_recall" in jres
    assert 0 < jres["bitmap_precision"] < 100
    assert 0 < jres["bitmap_recall"] < 100
    assert pres == pytest.approx(jres)


def test_cli_default_device_is_the_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(get_args_parser().parse_args(["--data-root", str(tmp_path)]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_overfits_debug_fixture_to_100pct(dtype, tmp_path):
    """tests/test_golden_overfit.py through the port's CLI: 100 epochs at
    --tiny, evaluate from the checkpoint, 100 % by the port's scorer."""
    root, out = _debug_root(tmp_path), tmp_path / "out"
    common = ["--tiny", "--device", "cpu", "--data-root", str(root),
              "--split", "debug", "--val-split", "debug", "--batch-size", "4",
              "--nodes-per-graph", "32", "--edges-per-graph", "64",
              "--output_dir", str(out), "--print-freq", "1000", "--dtype",
              dtype]
    stdout = _run_banned(_cli_script(root, out, [
        common + ["--epochs", "100", "--lr", "1e-3", "--validate-every",
                  "1000"],
        common + ["--evaluate", "--dump-result", "--dump-attentions",
                  "--resume", str(out / "ckpt")]]))
    assert "ACCURACY 100.0" in stdout, stdout[-2000:]
