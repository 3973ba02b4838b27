"""The port's steps as CUDA graphs (``graphvqa_tpu_torch/train/graphs.py``),
what can be checked of them on the CPU:

  (a) no step reads the device back or copies host data to it: each
      family's train and eval step runs under a dispatch mode that raises on
      the ops that do (``.item()``, ``bool()``, ``int()``, ``float()`` of a
      tensor, ``torch.tensor`` of host data) and on the ops whose output
      shape depends on the data (they read a count back), none of which a
      CUDA graph can hold;
  (b) the device-scalar optimizer over three float32 train steps across a
      StepLR drop (Adam's count 1-3) against the JAX package's
      ``make_train_step`` and against the optimizer with host scalars that
      the port had before, both at ``tests/test_torch_port_train.py``'s
      bounds: loss rtol 1e-5, parameters 1e-6 where every step's |gradient|
      > 1e-6, elsewhere 2 lr per step (an ill-conditioned first Adam
      step), running statistics rtol/atol 1e-5 beyond 0.1 x 2 lr per
      earlier step (the zero-gradient bias before each BatchNorm, as in the
      two-step comparison of that file);
  (c) ``train_one_epoch`` keeps each step's metrics apart when the step
      hands back the same tensors every call (a graph's static outputs);
  (d) the graph cache, with a capture function injected on the CPU (its
      'graph' reruns the body into the same output tensors, as a replay
      writes a graph's static outputs): one entry per (shapes, dtype) key,
      reused across calls, a bumped rung adds one, the first call at a key
      is the eager warm-up, every call advances the state once, and each
      eval request's answer is a tensor of its own.
The card's own check of capture against the eager step is
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` phase 14.
"""
import ast
import dataclasses
import pathlib
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import graphvqa_tpu_torch.config as pcfg
import graphvqa_tpu_torch.train.graphs as graphs_module
import graphvqa_tpu_torch.train.loop as loop
from graphvqa_tpu.config import Config as JaxConfig
from graphvqa_tpu.config import TrainConfig as JaxTrainConfig
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.train.loop import make_train_step as jax_make_train_step
from graphvqa_tpu.train.train_state import (
    create_train_state as jax_create_train_state)
from graphvqa_tpu_torch.models.convert import from_jax_variables
from graphvqa_tpu_torch.models.pipeline import PipelineModel, init_params
from graphvqa_tpu_torch.parallel.edge_sharded import make_edge_eval_step
from graphvqa_tpu_torch.parallel.mesh import Mesh
from graphvqa_tpu_torch.train.graphs import StepGraphs, batch_key
from graphvqa_tpu_torch.train.loop import (
    make_eval_step, make_train_step, train_one_epoch)
from graphvqa_tpu_torch.train.train_state import (
    ADAM_EPS, B1, B2, TrainState, create_train_state)
from tests.torch_port_dist import FakeCapture
from tests.torch_port_helpers import (
    jax_variables, port_batch, port_model, port_model_config,
    random_qa_batch, tiny_model_config)

LR, WD = 1e-3, 1e-2
TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (engine kind, program loss, execution engine)
FAMILIES = {"gat": ("gat", False, False), "gcn": ("gcn", True, False),
            "gine": ("gine", True, False), "lcgn": ("lcgn", True, False),
            "onlysg": ("none", False, False), "gat_exec": ("gat", False, True)}


def _family(name, dropout=True):
    kind, program, exe = FAMILIES[name]
    jcfg = tiny_model_config(kind, use_execution_engine=exe)
    if not dropout:
        jcfg = dataclasses.replace(
            jcfg, classifier_dropout=0.0,
            transformer=dataclasses.replace(jcfg.transformer, dropout=0.0),
            engine=dataclasses.replace(jcfg.engine, dropout=0.0))
    cfg = pcfg.Config(model=port_model_config(jcfg), train=pcfg.TrainConfig(
        lr=LR, weight_decay=WD, use_program_loss=program,
        use_bitmap_loss=exe))
    return jcfg, cfg


def _model(cfg, seed=0):
    model = PipelineModel(cfg.model)
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def _batch(jcfg, seed=1, dense=True, **widths):
    return port_batch(random_qa_batch(seed=seed, num_graphs=4, cfg=jcfg,
                                      dense=dense, **widths))


# --- (a) no read-back ---------------------------------------------------------

# ops that read a value back to the host or copy host data to the device
_READS = {"aten._local_scalar_dense.default", "aten.is_nonzero.default",
          "aten.lift_fresh.default", "aten.lift_fresh_copy.default",
          "aten.nonzero.default", "aten.masked_select.default",
          "aten.unique_consecutive.default", "aten._unique2.default",
          "aten.unique_dim.default"}


class NoReadBack(TorchDispatchMode):
    """Raises on every op a CUDA graph cannot hold because it reads the
    device back (or has a data-dependent shape), naming the op and the
    port's line. One read is allowed: ``ops/dense.py``'s
    ``edges_dst_sorted``, the CPU plain version's check of the kernel's
    edge order, which reads host tensors and which the CUDA path never
    runs (the kernel asserts the order on the device)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        bad = name in _READS
        if name.startswith(("aten.index.", "aten.index_put")):
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                      for i in (args[1] if len(args) > 1 else ()) or ())
        if name.startswith("aten.repeat_interleave.Tensor"):
            bad = kwargs.get("output_size") is None
        if bad:
            stack = traceback.extract_stack()
            if not any(f.name == "edges_dst_sorted" for f in stack):
                port = [f for f in stack if "graphvqa_tpu_torch" in f.filename]
                where = (f"{port[-1].filename}:{port[-1].lineno}" if port
                         else "?")
                raise AssertionError(f"{name} at {where}")
        return func(*args, **kwargs)


@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_steps_read_nothing_back(name, layout):
    jcfg, cfg = _family(name)
    model = _model(cfg)
    batch = _batch(jcfg, dense=layout == "dense")
    state = create_train_state(model, lr=LR, weight_decay=WD)
    train_step, eval_step = make_train_step(model, cfg), make_eval_step(
        model, cfg)
    gen, ctx = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    train_step(state, batch, gen, ctx)      # the count and lr set up once
    with NoReadBack():
        state, m = train_step(state, batch, gen, ctx)
        vectors, _, _ = eval_step(batch, ctx)
    assert state.step == 2 and torch.isfinite(m["total"])
    assert vectors["sa_pred"].shape == (4,)


def test_the_trap_catches_a_read_back():
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        with NoReadBack():
            float(torch.ones(2).sum())
    with pytest.raises(AssertionError, match="lift_fresh"):
        with NoReadBack():
            torch.tensor(3.0)


# --- (b) the optimizer against JAX ----------------------------------------------

class HostScalarState(TrainState):
    """The optimizer as the port had it before its scalars moved to the
    device: the count a Python int, the bias corrections and the learning
    rate Python floats, the last update fused into one add."""
    host_count: int = 0

    @torch.no_grad()
    def update(self, grads):
        names, params = zip(*self.model.named_parameters())
        gs = [torch.zeros_like(p) if grads.get(n) is None else grads[n]
              for n, p in zip(names, params)]
        mu = [self.opt_state["mu"][n] for n in names]
        nu = [self.opt_state["nu"][n] for n in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, gs, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - B2)
        self.host_count += 1
        mu_hat = torch._foreach_div(mu, 1.0 - B1 ** self.host_count)
        denom = torch._foreach_div(nu, 1.0 - B2 ** self.host_count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(upd, list(params), alpha=self.weight_decay)
        torch._foreach_add_(list(params), upd, alpha=-self.current_lr())


@pytest.fixture(scope="module")
def three_steps():
    """Three f32 steps (dropout off, lr_drop 2, the epoch moved past it
    before the third) of JAX's make_train_step and of the port's, with the
    device-scalar optimizer and with the host-scalar one."""
    jcfg, cfg = _family("gat", dropout=False)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr_drop=2))
    variables = jax_variables(jcfg, seed=2)
    jbs = [random_qa_batch(seed=5 + i, num_graphs=4, cfg=jcfg, dense=True)
           for i in range(3)]
    jstep = jax_make_train_step(JaxPipelineModel(jcfg), JaxConfig(
        model=jcfg, train=JaxTrainConfig(lr=LR, weight_decay=WD, lr_drop=2)))
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, variables),
                                    lr=LR, lr_drop=2, weight_decay=WD)
    jm = []
    for i, jb in enumerate(jbs):
        if i == 2:
            jstate = jstate.next_epoch().next_epoch()
        jstate, m = jstep(jstate, jb, jax.random.key(0))
        jm.append(float(m["total"]))

    def port(cls):
        model = port_model(jcfg, variables)
        base = create_train_state(model, lr=LR, lr_drop=2, weight_decay=WD)
        state = cls(**{f.name: getattr(base, f.name)
                       for f in dataclasses.fields(base)})
        step = make_train_step(model, cfg)
        losses, grads = [], []
        for i, jb in enumerate(jbs):
            if i == 2:
                state.next_epoch().next_epoch()
            state, m = step(state, port_batch(jb),
                            torch.Generator().manual_seed(0))
            losses.append(float(m["total"]))
            grads.append({n: torch.zeros_like(p) if p.grad is None
                          else p.grad.clone()
                          for n, p in model.named_parameters()})
        return dict(model=model, state=state, losses=losses, grads=grads)

    want = from_jax_variables({"params": jax.device_get(jstate.params),
                               "batch_stats": jax.device_get(
                                   jstate.batch_stats)})
    return dict(jax=dict(losses=jm, state=want, lr=float(
        jstate.current_lr())), device=port(TrainState),
        host=port(HostScalarState))


def _hold(got, want_losses, want_state):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    lrs = (LR, LR, 0.1 * LR)
    for name, p in got["model"].named_parameters():
        g, w = p.detach().numpy(), want_state[name].numpy()
        conditioned = np.all([np.abs(s[name].numpy()) > 1e-6
                              for s in got["grads"]], axis=0)
        np.testing.assert_allclose(g[conditioned], w[conditioned], rtol=0,
                                   atol=1e-6, err_msg=name)
        assert np.abs(g - w).max() <= 2 * sum(lrs), name
    sd = got["model"].state_dict()
    stats = [n for n in want_state
             if n.endswith(("running_mean", "running_var"))]
    assert stats
    for name in stats:
        # the BatchNorms' running statistics: the third step's forward sees
        # the biases before them after two ill-conditioned Adam steps
        np.testing.assert_allclose(sd[name].numpy(), want_state[name].numpy(),
                                   rtol=1e-5, atol=1e-5 + 0.1 * 2 * 2 * LR,
                                   err_msg=name)


def test_device_scalar_optimizer_matches_jax_across_an_lr_drop(three_steps):
    got, want = three_steps["device"], three_steps["jax"]
    _hold(got, want["losses"], want["state"])
    state = got["state"]
    assert state.step == 3 and state.epoch == 2
    count = state.opt_state["count"]
    assert count.dtype == torch.int32 and int(count) == 3
    assert state.lr_tensor.dtype == torch.float32
    np.testing.assert_allclose(float(state.lr_tensor), want["lr"], rtol=1e-6)


def test_device_scalar_optimizer_matches_the_host_scalar_one(three_steps):
    host = three_steps["host"]
    _hold(three_steps["device"], host["losses"], {
        **{n: p.detach() for n, p in host["model"].named_parameters()},
        **{n: b for n, b in host["model"].named_buffers()}})


def test_prepare_refills_the_lr_and_takes_a_checkpoints_int_count():
    jcfg, cfg = _family("gat")
    state = create_train_state(_model(cfg), lr=1e-2, lr_drop=1)
    state.opt_state["count"] = 7          # an older checkpoint's count
    state.prepare()
    assert state.opt_state["count"].dtype == torch.int32
    assert int(state.opt_state["count"]) == 7
    lr = state.lr_tensor
    assert float(lr) == np.float32(1e-2)
    state.epoch = 2
    state.prepare()
    assert state.lr_tensor is lr          # refilled in place
    assert float(lr) == np.float32(1e-4)


# --- (c) metrics stay apart ----------------------------------------------------

def test_train_one_epoch_keeps_each_steps_metrics(monkeypatch):
    """A step that returns the same tensors every call, as a graph's
    static outputs are: the meters must see every step's values."""
    seen = []

    class Recording(loop.AverageMeter):
        def update(self, val, n=1):
            seen.append((self.name, float(val), n))
            super().update(val, n)

    monkeypatch.setattr(loop, "AverageMeter", Recording)
    static = {k: torch.zeros((), dtype=torch.float32 if k == "total"
                             else torch.long) for k in loop._METER_KEYS}

    def step(state, batch, generator, ctx_generator=None):
        i = state["calls"] = state["calls"] + 1
        static["total"].fill_(0.5 * i)
        static["short_answer_total"].fill_(4)
        static["short_answer_correct"].fill_(i % 5)
        static["edge_count"].fill_(10 * i)
        for k in ("program", "program_group", "program_nonempty"):
            static[f"{k}_total"].fill_(10)
            static[f"{k}_correct"].fill_(i)
        return state, static

    state = {"calls": 0}
    train_one_epoch(step, state, [({}, None)] * 6, None, 0, print_freq=100)
    loss = [v for name, v, _ in seen if name == "Loss"]
    acc = [v for name, v, _ in seen if name == "Acc@Short"]
    assert loss == [0.5 * i for i in range(1, 7)]
    assert acc == [100.0 * (i % 5) / 4 for i in range(1, 7)]


# --- (d) the graph cache --------------------------------------------------------

def _inject(monkeypatch, capture):
    """make_train_step / make_eval_step build their graphs with
    ``capture`` wherever they are asked to capture (here, on the CPU)."""
    monkeypatch.setattr(loop, "_graphs", lambda model, on: (
        StepGraphs(capture) if on else None))


def test_one_graph_per_batch_key_and_an_eager_warm_up(monkeypatch):
    jcfg, cfg = _family("gat")
    model, ref_model = _model(cfg), _model(cfg)
    state = create_train_state(model, lr=LR, weight_decay=WD)
    ref_state = create_train_state(ref_model, lr=LR, weight_decay=WD)
    capture = FakeCapture()
    _inject(monkeypatch, capture)
    step = make_train_step(model, cfg)
    ref_step = make_train_step(ref_model, cfg, capture=False)
    assert ref_step.graphs is None
    graphs = step.graphs
    gen, ref_gen = (torch.Generator().manual_seed(3) for _ in range(2))
    main = [_batch(jcfg, seed=s) for s in (1, 2, 3)]
    bumped = _batch(jcfg, seed=4, nodes_per_graph=16, edges_per_graph=32)
    assert batch_key(main[0]) == batch_key(main[1]) != batch_key(bumped)

    def both(batch):
        _, m = step(state, batch, gen)
        _, r = ref_step(ref_state, batch, ref_gen)
        assert float(m["total"]) == float(r["total"])

    both(main[0])                 # the warm-up: eager, nothing captured
    assert (graphs.warm_ups, graphs.captures, capture.calls) == (1, 0, [])
    assert len(graphs.graphs) == 1
    both(main[1])                 # captures the key's graph and replays it
    assert (graphs.captures, graphs.replays) == (1, 1)
    assert capture.calls == [(gen,)]
    both(main[2])                 # replays
    assert (len(graphs.graphs), graphs.captures, graphs.replays) == (1, 1, 2)
    both(bumped)                  # a bumped rung: a new key, warmed up
    both(bumped)
    assert len(graphs.graphs) == 2
    assert (graphs.warm_ups, graphs.captures, graphs.replays) == (2, 2, 3)
    both(main[0])                 # the main rung replays, no new capture
    assert (graphs.captures, graphs.replays) == (2, 4)
    # each call advanced the state once, as the eager step did
    assert state.step == ref_state.step == 6
    assert int(state.opt_state["count"]) == 6
    for (n, p), q in zip(model.named_parameters(), ref_model.parameters()):
        assert torch.equal(p, q), n
    # the cache knows no kernel: graphs.py imports nothing from ops (read
    # from its source, as other tests have loaded ops already)
    imported = []
    for node in ast.walk(ast.parse(
            pathlib.Path(graphs_module.__file__).read_text())):
        if isinstance(node, ast.ImportFrom):
            imported += [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
    assert not [name for name in imported
                if name.startswith("graphvqa_tpu_torch.ops")], imported


def test_a_new_state_or_generator_drops_the_graphs(monkeypatch):
    jcfg, cfg = _family("lcgn")
    model = _model(cfg)
    state = create_train_state(model)
    capture = FakeCapture()
    _inject(monkeypatch, capture)
    step = make_train_step(model, cfg)
    batch = _batch(jcfg)
    gen, ctx = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    for _ in range(2):
        step(state, batch, gen, ctx)
    assert capture.calls == [(gen, ctx)]      # both generators registered
    other = create_train_state(model)
    step(other, batch, gen, ctx)
    assert (step.graphs.warm_ups, len(step.graphs.graphs)) == (2, 1)
    step(other, batch, gen, torch.Generator().manual_seed(1))
    assert step.graphs.warm_ups == 3


def test_eval_graphs_per_key_and_outputs_of_their_own(monkeypatch):
    jcfg, cfg = _family("gat_exec")
    model = _model(cfg)
    capture = FakeCapture()
    _inject(monkeypatch, capture)
    step = make_eval_step(model, cfg)
    ref = make_eval_step(model, cfg, capture=False)
    batches = [_batch(jcfg, seed=s) for s in (1, 2, 3)]
    outs = [step(b) for b in batches]
    assert (step.graphs.warm_ups, step.graphs.captures,
            step.graphs.replays) == (1, 1, 2)
    for b, (vec, tokens, att) in zip(batches, outs):
        rvec, rtokens, ratt = ref(b)
        assert set(vec) == set(rvec)
        for k in vec:
            assert torch.equal(vec[k], rvec[k]), k
        assert torch.equal(tokens, rtokens) and torch.equal(att, ratt)


def test_eager_on_the_cpu_and_edge_shards_refused(monkeypatch):
    """Eager on the CPU and with ``capture=False``; with a capture the edge
    eval step builds graphs and StepGraphs takes an edge-sharded batch (the
    name is the refusal's that this replaced)."""
    jcfg, cfg = _family("gat")
    model = _model(cfg)
    assert make_train_step(model, cfg).graphs is None
    assert make_eval_step(model, cfg).graphs is None
    _inject(monkeypatch, FakeCapture())
    assert make_train_step(model, cfg, capture=False).graphs is None
    assert make_eval_step(model, cfg, capture=False).graphs is None
    mesh = Mesh(data=1, edge=2, rank=0)
    assert make_edge_eval_step(model, cfg, mesh).graphs is not None
    assert make_edge_eval_step(model, cfg, mesh, capture=False).graphs is None
    batch = _batch(jcfg)
    sharded = dataclasses.replace(batch, graphs=dataclasses.replace(
        batch.graphs, edge_group=object()))
    graphs = StepGraphs(FakeCapture())
    for _ in range(3):
        assert graphs(lambda b: b.questions * 2, sharded).equal(
            batch.questions * 2)
    assert (graphs.warm_ups, graphs.captures, graphs.replays) == (1, 1, 2)
