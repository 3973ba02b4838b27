"""Small fixtures of the port that import no JAX, shared by the CPU parity
tests and the card tests (which run where JAX is not installed)."""
import numpy as np
import torch

from graphvqa_tpu_torch.core.packing import GraphSample, pack_graphs_dense
from graphvqa_tpu_torch.nn.gnn import GATSeq


def tiny_gat_seq(dtype, seed=0):
    """A 2-round GATSeq at narrow widths with seeded weights and BatchNorm
    statistics, and a packed batch of 3 ragged graphs plus a dummy, its
    node and edge features and instruction vectors (all on the CPU)."""
    torch.manual_seed(seed)
    C, D, R, heads = 12, 10, 2, 2
    seq = GATSeq(C, D, num_rounds=R, heads=heads, dtype=dtype).eval()
    with torch.no_grad():
        for conv in seq.convs:
            for att in (conv.att_l, conv.att_r, conv.att_e):
                att.normal_(0.0, 0.3)
            conv.bias.normal_(0.0, 0.1)
        for bn in seq.bns:
            bn.running_mean.normal_(0.0, 0.5)
            bn.running_var.uniform_(0.5, 2.0)
    rng = np.random.default_rng(seed)
    samples = []
    for n, e in ((5, 14), (9, 30), (2, 3)):
        samples.append(GraphSample(
            node_tokens=np.ones((n, 12), np.int32),
            edge_src=rng.integers(0, n, size=e).astype(np.int32),
            edge_dst=rng.integers(0, n, size=e).astype(np.int32),
            edge_tokens=np.ones((e, 1), np.int32), edge_sym=np.zeros(e, bool)))
    g = pack_graphs_dense(samples, 16, 64, num_graphs=4)
    x = torch.from_numpy(rng.normal(size=(g.nodes_pad, C)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(g.edges_pad, C)).astype(np.float32))
    ins = torch.from_numpy(rng.normal(size=(R, 4, D)).astype(np.float32))
    return seq, g, x, e, ins


def tiny_train_case(seed=0):
    """A float32 Config at narrow widths with every dropout at 0, and a
    packed QABatch of 3 ragged graphs (on the CPU)."""
    from graphvqa_tpu_torch import config as pc
    from graphvqa_tpu_torch.core.graph import QABatch
    model = pc.ModelConfig(
        text=pc.TextConfig(vocab_size=60, emb_dim=16),
        scene=pc.SceneGraphConfig(vocab_size=40, emb_dim=12),
        transformer=pc.TransformerConfig(hidden_dim=32, num_heads=4,
                                         ffn_dim=64, num_layers=2,
                                         dropout=0.0),
        engine=pc.EngineConfig(num_rounds=3, heads=2, dropout=0.0),
        num_answers=20, max_execution_steps=3, program_decode_len=8,
        full_answer_decode_len=8, classifier_hidden=32,
        classifier_dropout=0.0, dtype="float32")
    rng = np.random.default_rng(seed)
    samples = []
    for n, e in ((5, 9), (7, 14), (3, 4)):
        samples.append(GraphSample(
            rng.integers(2, 40, (n, 12)).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(2, 40, (e, 1)).astype(np.int32), rng.random(e) > 0.7))
    g = pack_graphs_dense(samples, 8, 16, max_steps=3)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    batch = QABatch(g, t(rng.integers(4, 60, (3, 7))),
                    t(rng.integers(4, 60, (9, 6))),
                    t(rng.integers(4, 60, (3, 8))), t(rng.integers(0, 20, (3,))))
    return pc.Config(model=model), batch
