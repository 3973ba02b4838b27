from graphvqa_tpu_torch.core.device import resolve_device
from graphvqa_tpu_torch.core.graph import GraphBatch, QABatch
from graphvqa_tpu_torch.core.packing import (
    GraphSample, pack_graphs, pack_graphs_dense, pick_bucket, pick_dense_epg,
    pick_dense_npg)

__all__ = ["resolve_device", "GraphBatch", "QABatch", "GraphSample",
           "pack_graphs", "pack_graphs_dense", "pick_bucket",
           "pick_dense_epg", "pick_dense_npg"]
