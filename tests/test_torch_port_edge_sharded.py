"""The port's destination-ownership edge sharding against the JAX package,
on the CPU.

The partition itself (numpy and the native packer's ``gp_shard_by_dst``)
is compared with JAX's ``shard_edges_by_dst`` without spawning. The train
and eval steps run on spawned gloo ranks (``tests/torch_port_dist.py``),
started before the JAX side compiles: every family JAX's own edge tests
cover (gat, gcn, gine, lcgn) at data 1 x edge 2, gat with 2 steps per
call, gat at data 2 x edge 2 on two distinct batches, the edge eval step,
and validate at data 2 x edge 2; then gat's steps captured, with
``tests/torch_port_dist.py``'s FakeCapture installed in each rank (three
steps at 1 x 2 and at 2 x 2, K=2, three eval requests), held bitwise to
the eager ones and to JAX's, with one segment per host collective + 1 and
the eager step's collectives in order. JAX's edge steps run on its conftest's
emulated host devices; LCGN's context features are one fixed draw on both
sides (``tests/test_torch_port_engines.py``). The bounds of the train steps
are ``tests/test_torch_port_parallel.py``'s; the eval step's: greedy tokens
and predictions equal, the short-answer score rtol 1e-4 / atol 5e-5 and the
node attention atol 1e-5 (the port's eval-step bounds, within JAX's own
rtol 5e-4 / atol 5e-5).
"""
import jax
import numpy as np
import pytest
import torch

from graphvqa_tpu.core.packing import GraphSample as JaxGraphSample
from graphvqa_tpu.core.packing import pack_graphs_dense as jax_pack_dense
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.parallel.edge_sharded import (
    dst_shard_need as jax_dst_shard_need, make_dp_edge_train_step,
    make_edge_eval_step, prepare_dp_edge_batch, prepare_edge_eval_batch,
    shard_edges_by_dst as jax_shard_edges_by_dst)
from graphvqa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from graphvqa_tpu_torch.core.native import (
    native_available, shard_edges_by_dst_native)
from graphvqa_tpu_torch.ops.dense import dense_local_indices
from graphvqa_tpu_torch.ops.gat_round import edges_dst_sorted
from graphvqa_tpu_torch.parallel.edge_sharded import (
    EDGE_FIELDS, dst_shard_need, local_shard, shard_edges_by_dst)
from tests import torch_port_dist
from tests.test_torch_port_engines import _fixed_normal, _noise
from tests.test_torch_port_parallel import (
    LR, WD, assert_step_matches, assert_validate_matches, jax_config,
    jax_state, port_config, shrunk_config, to_port, validate_case)
from tests.torch_port_helpers import (
    jax_variables, port_batch, port_graph, port_model, random_qa_batch)

FAMILIES = ("gat", "gcn", "gine", "lcgn")


# --- the partition -----------------------------------------------------------

def _hub_graph():
    """One graph whose 14 edges all point at node 1 (a bucket overflow)."""
    n, e = 6, 14
    s = JaxGraphSample(
        node_tokens=np.full((n, 12), 4, np.int32),
        edge_src=np.arange(e, dtype=np.int32) % n,
        edge_dst=np.full((e,), 1, np.int32),
        edge_tokens=np.full((e, 1), 4, np.int32), edge_sym=np.zeros(e, bool))
    return jax_pack_dense([s], 8, 16)


def _assert_same_shards(got, want, k):
    for f in EDGE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert getattr(got, "edge_src").shape[0] == k


@pytest.mark.parametrize("case", ["random-k2", "random-k4", "hub-k4",
                                  "given-padding"])
def test_shard_edges_by_dst_equals_jax(case):
    k = 2 if case == "random-k2" else 4
    g = (_hub_graph() if case == "hub-k4" else random_qa_batch(
        seed=9, num_graphs=3, dense=True, nodes_per_graph=8,
        edges_per_graph=16).graphs)
    given = 8 if case == "given-padding" else None
    want = jax_shard_edges_by_dst(g, k, edges_per_shard=given)
    pg = port_graph(g)
    assert dst_shard_need(pg, k) == jax_dst_shard_need(g, k)
    for fn in (shard_edges_by_dst, shard_edges_by_dst_native):
        _assert_same_shards(fn(pg, k, given), want, k)
    if case == "hub-k4":      # epg // k = 4 < 14: bumped to the graph's 16
        assert want.edge_src.shape[1] == 16


def test_native_shard_binding_is_in_use():
    assert native_available()


def test_shard_overflow_with_a_given_padding_raises():
    pg = port_graph(_hub_graph())
    for fn in (shard_edges_by_dst, shard_edges_by_dst_native):
        with pytest.raises(ValueError, match="overflow"):
            fn(pg, 4, 4)


@pytest.mark.parametrize("k", [2, 4])
def test_each_shard_keeps_the_kernels_edge_order(k):
    """Every shard's real edges come first, destination-sorted, its padding
    last (the GAT kernel's precondition), and each real edge lies on the
    shard that owns its destination."""
    g = port_graph(random_qa_batch(seed=11, num_graphs=4, dense=True,
                                   nodes_per_graph=16,
                                   edges_per_graph=64).graphs)
    sharded = shard_edges_by_dst_native(g, k)
    total = 0
    for e in range(k):
        s = local_shard(sharded, e, None)
        dl, sl = dense_local_indices(s)
        mask = s.edge_mask.reshape(s.num_graphs, -1).float()
        assert edges_dst_sorted(dl, sl, mask, s.nodes_per_graph)
        real = s.edge_mask
        assert ((dl.reshape(-1)[real] % k) == e).all()
        total += int(real.sum())
    assert total == int(g.edge_mask.sum())


@pytest.mark.parametrize("given_max", [True, False],
                         ids=["group-max", "own-max"])
def test_gat_round_shares_sum_to_the_whole_round(given_max):
    """The GAT round on each edge rank's share, given the group's graph max
    (graph_logit_max, max over the shares), sums to the whole round, and so
    do its gradients (rtol/atol 1e-5). With each share's own max the
    forward still sums (any shift common to a destination's edges is
    valid) but the gradients of alpha_l / alpha_r do not: JAX's derivative
    of minimum(shifted, 0) is 1/2 at the shift, and it would fall on each
    share's own maximum edge."""
    from graphvqa_tpu_torch.ops.gat_round import gat_round, graph_logit_max
    g = port_graph(random_qa_batch(seed=12, num_graphs=4, dense=True,
                                   nodes_per_graph=16,
                                   edges_per_graph=64).graphs)
    B, npg, H, C = g.num_graphs, g.nodes_per_graph, 2, 5
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(*shape, generator=gen).requires_grad_()
              for shape in ((B * npg, H), (B * npg, H), (B * npg, H, C),
                            (B, H, C))]
    al, ar, xw, ins = leaves
    ae_node = torch.randn(B * npg, H, generator=gen)     # per edge, by src
    weight = torch.randn(B * npg, C, generator=gen)

    def args(graph):
        dl, sl = dense_local_indices(graph)
        b, e = graph.num_graphs, graph.edges_per_graph
        return (dl, sl, graph.edge_mask.reshape(b, e).float(), al, ar,
                ae_node.index_select(0, graph.edge_src).reshape(b, e, H))

    def round_and_grads(outs_fn):
        out = outs_fn()
        grads = torch.autograd.grad((out * weight).sum(), leaves)
        return out.detach(), grads

    whole = round_and_grads(lambda: gat_round(*args(g), xw, ins, npg=npg,
                                              epg=64))
    shares = [local_shard(shard_edges_by_dst(g, 2), e, None)
              for e in range(2)]
    gmax = torch.stack([graph_logit_max(*args(s), npg=npg)
                        for s in shares]).amax(dim=0)
    sharded = round_and_grads(lambda: sum(
        gat_round(*args(s), xw, ins, npg=npg, epg=s.edges_per_graph,
                  shift_max=gmax if given_max else None) for s in shares))
    torch.testing.assert_close(sharded[0], whole[0], rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("al", "ar", "xw", "ins"), sharded[1],
                               whole[1]):
        close = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        assert close == (given_max or name in ("xw", "ins")), name


# --- the steps ---------------------------------------------------------------

def _batch(seed, cfg, num_graphs=3):
    return random_qa_batch(seed=seed, num_graphs=num_graphs, dense=True,
                           nodes_per_graph=8, edges_per_graph=16, cfg=cfg)


@pytest.fixture(scope="module")
def edge_run(tmp_path_factory):
    """A world-2 spawn (every family at 1 x 2, gat with K=2, the edge eval
    step) and a world-4 spawn (gat at 2 x 2, validate at 2 x 2); JAX's
    steps meanwhile."""
    tmp = tmp_path_factory.mktemp("edge")
    cases, want = {}, {}
    plan2 = []
    for kind in FAMILIES:
        jcfg = shrunk_config(kind)
        variables = jax_variables(jcfg, seed=50)
        jb = _batch(60, jcfg)
        noise = _noise(jcfg, jb) if kind == "lcgn" else None
        cases[kind] = (jcfg, variables, jb, noise)
        plan2.append(dict(
            kind="train", data=1, edge=2, cfg=port_config(jcfg),
            state_dict=port_model(jcfg, variables).state_dict(), lr=LR,
            wd=WD, batches=[[port_batch(jb)]],
            noise=None if noise is None else torch.from_numpy(noise)))
    jcfg, variables, jb, _ = cases["gat"]
    jb2 = _batch(61, jcfg)
    pb, pb2 = port_batch(jb), port_batch(jb2)
    gat = dict(plan2[0])
    plan2.append(dict(gat, batches=[[pb, pb2]]))
    evals = dict(kind="eval", data=1, edge=2, cfg=gat["cfg"],
                 state_dict=gat["state_dict"], batch=pb)
    plan2.append(evals)
    # captured (FakeCapture): three steps (warm-up, capture, replay) and
    # the same eager; K=2 (the warm-up, then the capture); three requests
    three = dict(gat, k=1, batches=[[pb, pb2, pb]])
    plan2 += [dict(three, capture=True), three,
              dict(gat, batches=[[pb, pb2]], capture=True),
              dict(evals, capture=True, requests=3)]
    vcase = validate_case(tmp, 2, 2, tmp / "ranks4")
    grid = dict(gat, data=2, k=1, batches=[[pb] * 3, [pb2] * 3])
    plan4 = [dict(gat, data=2, batches=[[pb], [pb2]]), vcase,
             dict(grid, capture=True), grid]
    run2 = torch_port_dist.start(2, tmp / "run2", plan2)
    run4 = torch_port_dist.start(4, tmp / "run4", plan4)

    mesh2 = jax_make_mesh(data=1, edge=2, devices=jax.devices()[:2])
    for kind, (jcfg, variables, b, noise) in cases.items():
        model, jc = JaxPipelineModel(jcfg), jax_config(jcfg)
        step = make_dp_edge_train_step(model, jc, mesh2)
        batch = prepare_dp_edge_batch([b], mesh2)
        if noise is None:
            state, m = step(jax_state(variables), batch, jax.random.key(7))
        else:
            with _fixed_normal(noise):
                state, m = step(jax_state(variables), batch,
                                jax.random.key(7))
        want[kind] = (to_port(state, variables, kind), m)
        if kind == "gat":
            # the captured three steps' reference: the step twice more
            state, _ = step(state, prepare_dp_edge_batch([jb2], mesh2),
                            jax.random.key(7))
            state, m = step(state, batch, jax.random.key(7))
            want["gat_three"] = (to_port(state, variables, "gat"), m)
    jcfg, variables, _, _ = cases["gat"]
    model, jc = JaxPipelineModel(jcfg), jax_config(jcfg)
    state, m = make_dp_edge_train_step(model, jc, mesh2,
                                       steps_per_dispatch=2)(
        jax_state(variables),
        prepare_dp_edge_batch([jb, jb2], mesh2, steps=2), jax.random.key(7))
    want["gat_k2"] = (to_port(state, variables, "gat"), m)
    want["eval"] = make_edge_eval_step(model, jc, mesh2)(
        jax_state(variables), prepare_edge_eval_batch(jb, mesh2),
        jax.random.key(13))
    mesh4 = jax_make_mesh(data=2, edge=2, devices=jax.devices()[:4])
    step = make_dp_edge_train_step(model, jc, mesh4)
    batch = prepare_dp_edge_batch([jb, jb2], mesh4)
    state, m = step(jax_state(variables), batch, jax.random.key(7))
    want["gat_2x2"] = (to_port(state, variables, "gat"), m)
    for _ in range(2):
        state, m = step(state, batch, jax.random.key(7))
    want["gat_2x2_three"] = (to_port(state, variables, "gat"), m)
    return dict(want=want, ranks2=torch_port_dist.collect(run2),
                ranks4=torch_port_dist.collect(run4), vcase=vcase)


# the cases' places in each rank's results (edge_run's plans)
EAGER_K2, EVAL = len(FAMILIES), len(FAMILIES) + 1
CAPTURED_THREE, EAGER_THREE, CAPTURED_K2, CAPTURED_EVAL = (
    len(FAMILIES) + i for i in range(2, 6))
GRID_CAPTURED, GRID_EAGER = 2, 3

# host calls of the shrunk gat (2 rounds) at data x edge: the forward's
# MetaLayer assembly and each round's pmax and assembly, the backward's
# assemblies, the step's all-reduce
FORWARD_CUTS = 1 + 2 * 2
TRAIN_CUTS = FORWARD_CUTS + (1 + 2) + 1


@pytest.mark.parametrize("kind", FAMILIES)
def test_edge_step_matches_jax(edge_run, kind):
    i = FAMILIES.index(kind)
    state, metrics = edge_run["want"][kind]
    for rank in edge_run["ranks2"]:
        got = rank[i]
        assert_step_matches(got, state, metrics)
        assert got["epg_loc"] == [8]        # epg 16 over 2 edge ranks
        assert got["metrics"]["short_answer_total"] == 3


def test_edge_ranks_hold_gradient_shares(edge_run):
    """Each edge rank's own .grad is a share: the two shares differ, and
    their sum is the gradient Adam took (JAX's mu / 0.1)."""
    want = edge_run["want"]["gat"][0]["mu"]
    r0, r1 = (r[0] for r in edge_run["ranks2"])
    differ = 0
    for name, g0 in r0["grads"].items():
        g1 = r1["grads"][name]
        if g0 is None:
            continue
        differ += not torch.equal(g0, g1)
        w = want[name].numpy() / np.float32(0.1)
        np.testing.assert_allclose((g0 + g1).numpy(), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max() + 5e-8,
                                   err_msg=name)
    assert differ > 10


def test_edge_two_steps_per_call_match_jax(edge_run):
    state, metrics = edge_run["want"]["gat_k2"]
    got = edge_run["ranks2"][0][len(FAMILIES)]
    assert_step_matches(got, state, metrics)
    assert got["metrics"]["short_answer_total"] == 6


def test_data_times_edge_step_matches_jax(edge_run):
    state, metrics = edge_run["want"]["gat_2x2"]
    for rank in edge_run["ranks4"]:
        assert_step_matches(rank[0], state, metrics)
        assert rank[0]["metrics"]["short_answer_total"] == 6


def test_edge_eval_step_matches_jax(edge_run):
    vec, prog, att = edge_run["want"]["eval"]
    prog, att = np.asarray(prog), np.asarray(att)
    for rank in edge_run["ranks2"]:
        got = rank[len(FAMILIES) + 1]
        np.testing.assert_array_equal(got["program_tokens"].numpy(), prog)
        np.testing.assert_array_equal(got["vectors"]["sa_pred"].numpy(),
                                      np.asarray(vec["sa_pred"]))
        np.testing.assert_allclose(got["vectors"]["sa_score"].numpy(),
                                   np.asarray(vec["sa_score"]), rtol=1e-4,
                                   atol=5e-5)
        np.testing.assert_allclose(got["node_attention"].numpy(), att,
                                   rtol=0, atol=1e-5)


def test_validate_at_data_times_edge_matches_one_process(edge_run, tmp_path):
    """Four ranks: each data rank's shard evaluated edge-sharded; the meters
    synced over the data group count every question once, and rank 0's
    gathered dump holds each question once."""
    assert_validate_matches(edge_run["vcase"],
                            [r[1] for r in edge_run["ranks4"]], tmp_path)


# --- the steps captured (FakeCapture in each rank) ---------------------------

def _assert_bitwise(got, want):
    assert got["call_metrics"] == want["call_metrics"]
    for part in ("params", "mu", "nu", "stats", "grads"):
        assert got[part].keys() == want[part].keys()
        for name, w in want[part].items():
            g = got[part][name]
            assert (g is None and w is None) or torch.equal(g, w), \
                f"{part} {name}"


@pytest.mark.parametrize("grid", ["1x2", "1x2-k2", "2x2"])
def test_captured_edge_steps_equal_the_eager_ones_bitwise(edge_run, grid):
    ranks, cap, eager, calls = {
        "1x2": ("ranks2", CAPTURED_THREE, EAGER_THREE, (1, 1, 2)),
        "1x2-k2": ("ranks2", CAPTURED_K2, EAGER_K2, (1, 1, 1)),
        "2x2": ("ranks4", GRID_CAPTURED, GRID_EAGER, (1, 1, 2))}[grid]
    for rank in edge_run[ranks]:
        assert rank[cap]["graphs"] == calls
        assert rank[eager]["graphs"] is None
        _assert_bitwise(rank[cap], rank[eager])


@pytest.mark.parametrize("grid", ["1x2", "1x2-k2", "2x2"])
def test_captured_edge_steps_match_jax(edge_run, grid):
    ranks, i, want, total = {
        "1x2": ("ranks2", CAPTURED_THREE, "gat_three", 3),
        "1x2-k2": ("ranks2", CAPTURED_K2, "gat_k2", 6),
        "2x2": ("ranks4", GRID_CAPTURED, "gat_2x2_three", 6)}[grid]
    state, metrics = edge_run["want"][want]
    for rank in edge_run[ranks]:
        assert_step_matches(rank[i], state, metrics)
        assert rank[i]["metrics"]["short_answer_total"] == total


def test_captured_edge_eval_step_matches_jax_and_eager(edge_run):
    vec, prog, att = edge_run["want"]["eval"]
    for rank in edge_run["ranks2"]:
        got = rank[CAPTURED_EVAL]
        assert got["graphs"] == (1, 1, 2)
        for out in got["requests"]:
            np.testing.assert_array_equal(out["program_tokens"].numpy(),
                                          np.asarray(prog))
            np.testing.assert_array_equal(out["vectors"]["sa_pred"].numpy(),
                                          np.asarray(vec["sa_pred"]))
            np.testing.assert_allclose(out["vectors"]["sa_score"].numpy(),
                                       np.asarray(vec["sa_score"]),
                                       rtol=1e-4, atol=5e-5)
            np.testing.assert_allclose(out["node_attention"].numpy(),
                                       np.asarray(att), rtol=0, atol=1e-5)
            eager = rank[EVAL]
            assert torch.equal(out["program_tokens"], eager["program_tokens"])
            assert torch.equal(out["node_attention"], eager["node_attention"])
            for k, v in eager["vectors"].items():
                assert torch.equal(out["vectors"][k], v), k


@pytest.mark.parametrize("case", ["train-1x2", "train-2x2", "eval"])
def test_captured_edge_steps_cut_at_each_collective(edge_run, case):
    """A captured step holds one segment per host call + 1, captured in the
    relaxed mode, and every call, warm-up, capture and replay, makes the
    eager step's all-reduces in number and order (op, shape, dtype)."""
    ranks, cap, eager, cuts = {
        "train-1x2": ("ranks2", CAPTURED_THREE, EAGER_THREE, TRAIN_CUTS),
        "train-2x2": ("ranks4", GRID_CAPTURED, GRID_EAGER, TRAIN_CUTS),
        "eval": ("ranks2", CAPTURED_EVAL, EVAL, FORWARD_CUTS)}[case]
    for rank in edge_run[ranks]:
        got = rank[cap]
        assert (got["cuts"], got["segments"], got["modes"]) == (
            [cuts], [cuts + 1], ["relaxed"])
        want = rank[eager]["reduce_calls"][0]
        assert len(want) == cuts
        assert got["reduce_calls"] == [want] * len(got["reduce_calls"])
