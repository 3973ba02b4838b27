"""Set-up shared by every cell: the traffic written where the port's
dataset reads it, the vocabularies, the model with the benchmark's weights,
and the per-batch real counts the metrics read."""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import shutil
import tempfile

import numpy as np
import torch

from harness import traffic as traffic_mod
from harness.weights import batch_norm_stats, make_weights
from reference import inputs as ref_inputs


@dataclasses.dataclass
class Setup:
    cfg: object                 # the port's Config
    cfg_dict: dict              # the configuration file's model tree
    traffic: dict
    questions: list
    scenes: dict
    reader: ref_inputs.Reader
    dataset: object             # the port's GQADataset
    data_dir: pathlib.Path


def data_root() -> pathlib.Path:
    """A fresh directory under TMPDIR for this run's traffic files."""
    base = pathlib.Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    return pathlib.Path(tempfile.mkdtemp(prefix="graphvqa_bench_", dir=base))


def prepare(cfg, cfg_dict: dict, traffic: dict, seed: int,
            share=None) -> Setup:
    """Generate the traffic from ``seed``, write it, build the vocabularies
    (handed to the port and to the reference alike) and open the port's
    dataset on the files. ``share`` (several ranks): rank 0 writes the
    files and hands their directory on (``share(path)``), the other ranks
    take it (``share(None)``) and read them."""
    from graphvqa_tpu_torch.data.dataset import GQADataset
    from graphvqa_tpu_torch.data.vocab import Vocab
    if share is None or share.rank == 0:
        questions, scenes = traffic_mod.make_split(traffic, seed)
        root = data_root()
        programs, graphs = traffic_mod.write_split(root, traffic, questions,
                                                   scenes)
        if share is not None:
            share.publish(root)
    else:
        root = share.receive()
        programs, graphs = traffic_mod.split_paths(root, traffic)
        questions = json.loads(programs.read_text())
        scenes = json.loads(graphs.read_text())
    # the benchmark's own copy of the traffic (millions of small objects
    # the program never holds) out of the garbage collector's reach, so
    # that it does not lengthen the program's collections in the window
    gc.freeze()
    text_itos = ref_inputs.text_itos(questions)
    vocab_size = cfg.model.text.vocab_size
    if len(text_itos) > vocab_size:
        raise ValueError(f"the traffic's text vocabulary ({len(text_itos)}) "
                         f"exceeds the configuration's {vocab_size}")
    scene_itos = ref_inputs.scene_itos()
    if len(scene_itos) != cfg.model.scene.vocab_size:
        raise ValueError(f"scene vocabulary {len(scene_itos)} != the "
                         f"configuration's {cfg.model.scene.vocab_size}")
    ds = GQADataset(programs, graphs, Vocab(text_itos), Vocab(scene_itos))
    ds.prewarm()
    b = cfg.batch
    reader = ref_inputs.Reader(
        questions, scenes, {t: i for i, t in enumerate(text_itos)},
        {t: i for i, t in enumerate(scene_itos)}, traffic_mod.answer_map(),
        dict(question_len=b.question_len, program_len=b.program_len,
             full_answer_len=b.full_answer_len))
    return Setup(cfg, cfg_dict, traffic, questions, scenes, reader, ds, root)


def cleanup(setup: Setup, owner: bool = True) -> None:
    """Stop the dataset's pool; ``owner`` also removes the traffic files."""
    setup.dataset.close()
    if owner:
        shutil.rmtree(setup.data_dir, ignore_errors=True)


def leaf_shapes(model) -> dict:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def build_model(cfg, seed: int, device):
    """The port's model on ``device`` holding the benchmark's weights ->
    (model, weights): the weights stay the benchmark's, for the check."""
    from graphvqa_tpu_torch.models.pipeline import PipelineModel
    with torch.device(device):
        model = PipelineModel(cfg.model)
    shapes = leaf_shapes(model)
    weights = make_weights(shapes, seed, device, cfg.model.engine.kind)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    left = [k for k in missing if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    if left or unexpected:
        raise RuntimeError(f"weights do not fit the model: missing {left}, "
                           f"unexpected {unexpected}")
    return model.eval(), weights


def reference_params(shapes: dict, seed: int, device,
                     engine_kind: str) -> dict:
    """The same weights made again from the seed, with BatchNorm's initial
    running statistics: the reference's parameters."""
    params = make_weights(shapes, seed, device, engine_kind)
    params.update(batch_norm_stats(shapes, device))
    return params


def batch_counts(reader, rows, train: bool, cfg) -> dict:
    """Real counts of the batch of dataset ``rows`` (its real rows only)
    for the operation count, and the sizes the GAT bound reads."""
    sizes = np.asarray([reader.sizes(str(reader.questions[r][0]))
                        for r in rows], np.int64)
    L = cfg.batch
    q, prog = [], []
    for r in rows:
        qt, pt = reader.token_counts(r)
        q.append(qt)
        prog.append(pt if train else
                    [cfg.model.program_decode_len - 1] * len(pt))
    npg, epg = reader.shape(rows, L.nodes_per_graph, L.edges_per_graph)
    return dict(q_tokens=np.asarray(q), prog_positions=np.asarray(prog),
                nodes=sizes[:, 0], edges=sizes[:, 1],
                n_src=int(sizes[:, 2].sum()), n_dst=int(sizes[:, 3].sum()),
                n_edges=int(sizes[:, 1].sum()), B=L.num_graphs, npg=npg,
                epg=epg)


@dataclasses.dataclass
class Window:
    """What a run measured, as the metric readers read it."""
    mode: str
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    questions: int = 0
    # the part of the window the host-clock per-layer metrics read: the
    # whole window, or in a traced run the part before the profiler starts
    host_s: float = 0.0
    host_steps: int = 0
    host_flops: float = 0.0
    batch_s: list = dataclasses.field(default_factory=list)
    metas: list = dataclasses.field(default_factory=list)
    trace: dict = None
    trace_metas: list = None
    compiled_in_window: int = 0
    memory_peak: int = 0
    check: dict = None
    shapes: dict = None
    # filled after the window by the harness
    flops: float = 0.0
    chips: int = 1
    peak_flops: float = 0.0
    peak_bytes_per_s: float = 0.0
    gat_bytes: tuple = (0, 0)
    gat_kernels: tuple = ()


def stamp(what: str, t_start: float) -> None:
    """A set-up milestone on standard error, seconds since process start."""
    import sys
    import time
    print(f"set-up: {what} at {time.perf_counter() - t_start:.2f} s",
          file=sys.stderr, flush=True)


class GCMeter:
    """The garbage collector's pauses between ``start`` and ``stop``:
    count, total and longest seconds, written to standard error."""

    def start(self):
        import time
        self.n, self.total, self.longest, self.t0 = 0, 0.0, 0.0, None

        def callback(phase, info):
            if phase == "start":
                self.t0 = time.perf_counter()
            elif self.t0 is not None:
                dt = time.perf_counter() - self.t0
                self.n, self.total = self.n + 1, self.total + dt
                self.longest = max(self.longest, dt)
        self.callback = callback
        gc.callbacks.append(callback)
        return self

    def stop(self):
        import sys
        gc.callbacks.remove(self.callback)
        print(f"window: {self.n} garbage collections, {1e3 * self.total:.1f}"
              f" ms in all, the longest {1e3 * self.longest:.1f} ms",
              file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
