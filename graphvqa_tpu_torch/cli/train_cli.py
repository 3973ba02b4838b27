"""Training / evaluation entry point of the port: the port of
``graphvqa_tpu/cli/train_cli.py``, with the same flags, defaults and output
files.

    python -m graphvqa_tpu_torch.cli.train_cli --model gat \
        --data-root /path/to/GraphVQA --split train_balanced \
        --epochs 200 --batch-size 200 --lr 1e-4 --lr-drop 90

    python -m graphvqa_tpu_torch.cli.train_cli --model gat --evaluate \
        --resume outputdir/ckpt --split val_balanced --dump-result

It reads ``<data-root>/questions/<split>_programs.json`` and
``<data-root>/sceneGraphs/{train,val}_sceneGraphs.json`` and writes, under
``--output_dir``: ``log-<model>.txt``, ``text_vocab.json``, ``ckpt/`` (and
``ckpt%04d_lrdrop`` / ``ckpt%04d`` archival copies), ``dump_results*.json``
and ``dump_attentions*.json``, which ``graphvqa_tpu_torch.eval.scorer``
reads.

It runs on the GPU (``--device cuda``, the default; raises without one) or,
when asked, on the CPU (``--device cpu``). ``--workers N`` collates in N
forked processes (data/dataset.py): they fork after the model is on the
card and never touch it, returning numpy arrays. ``--model`` takes every
family of the JAX package (gat, gcn, gine, lcgn, onlysg), each with its
configuration's losses, and ``--use-execution-engine`` adds the recurrent
execution engine with its bitmap loss and meters; LCGN draws its context
features from a generator seeded with ``--seed`` + 2. ``--compile-cache``
and ``--prng`` name JAX machinery and do nothing here.

A single process on the card runs each train and eval step as the replay of
a CUDA graph, one graph per batch shape (``train/graphs.py``), as the JAX
CLI runs one jitted program per ladder rung: the first step at a shape runs
eagerly, the second captures its graph. The graphs live in the process, so
nothing persists across runs the way ``--compile-cache`` keeps JAX's
programs; the CLI prints the warm-ups, captures and replays after each
epoch and evaluation, each rank's under torchrun. Several ranks capture
alike, on every (data, edge) mesh: over gloo a step's graphs are cut at
each collective, which runs on the host between two of them.

Several GPUs: launch one process per rank with torchrun, and split the
ranks into ``--data-parallel`` D x ``--edge-parallel`` K = WORLD_SIZE:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m graphvqa_tpu_torch.cli.train_cli --data-parallel 2 \
        --edge-parallel 2 ...

Each data rank trains and evaluates its own shard of the batches
(``parallel/data_parallel.py``); the K ranks of a data index share its
batches, each holding the edges of the destinations it owns
(``parallel/edge_sharded.py``, dense layout only, ``--nodes-per-graph``
divisible by K). NCCL gives each rank a card of its own; ``--dist-backend
gloo`` lets ranks share cards (and is the backend on the CPU). Rank 0 alone
prints, logs and writes the checkpoints and the dumps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import pathlib
import random
import time

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser("GraphVQA training and evaluation (PyTorch)",
                                add_help=False)
    p.add_argument("--model", default="gat",
                   choices=["gat", "gcn", "gine", "lcgn", "onlysg"])
    p.add_argument("--data-root", type=str, required=True,
                   help="directory with questions/*_programs.json and "
                        "sceneGraphs/*_sceneGraphs.json")
    p.add_argument("--split", default="train_balanced")
    p.add_argument("--val-split", default="val_balanced")
    p.add_argument("--epochs", default=200, type=int)
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--batch-size", default=200, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr-drop", default=90, type=int)
    p.add_argument("--wd", "--weight-decay", default=0.0, type=float,
                   dest="weight_decay")
    p.add_argument("--clip-grad", default=0.0, type=float, metavar="NORM",
                   help="global gradient-norm clip before Adam (0 = off)")
    p.add_argument("-j", "--workers", default=0, type=int,
                   help="batch-collate worker processes, forked after the "
                        "model is built (they touch no device); 0 collates "
                        "in-process")
    p.add_argument("--size-bucket", default=16, type=int, metavar="W",
                   help="cut training batches from windows of W*batch "
                        "shuffled samples sorted by scene size, so one big "
                        "graph bumps few batches to a bigger rung; 0 "
                        "disables")
    p.add_argument("--print-freq", default=100, type=int)
    p.add_argument("--resume", default="", help="checkpoint dir to resume from")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--evaluate-sets", "--evaluate_sets", default=None,
                   nargs="+", dest="evaluate_sets",
                   help="evaluate these splits; implies --evaluate")
    p.add_argument("--fast-validate", default=0, type=int, metavar="N",
                   help="stop validation after N batches; 0 = full")
    p.add_argument("--validate-every", default=5, type=int,
                   help="validate every N epochs")
    p.add_argument("--dump-result", action="store_true")
    p.add_argument("--dump-attentions", action="store_true",
                   help="also dump object-based attention maps for the "
                        "official grounding metric")
    p.add_argument("--glove", default="",
                   help="GloVe file (.txt glove.6B.300d format, or a cached "
                        ".npy matrix) injected into the shared text "
                        "embedding at init")
    p.add_argument("--glove-allow-missing", action="store_true",
                   help="proceed with zero-injected embeddings when --glove "
                        "points at a nonexistent file (default: error)")
    p.add_argument("--glove-sg", action="store_true",
                   help="also inject GloVe into the scene-graph embedding")
    p.add_argument("--seed", default=1234, type=int)
    p.add_argument("--output_dir", "--output-dir", default="./outputdir",
                   dest="output_dir")
    p.add_argument("--layout", default="dense", choices=["dense", "flat"],
                   help="graph layout of the batches (BatchConfig.layout)")
    p.add_argument("--nodes-per-graph", default=64, type=int,
                   help="dense layout: uniform per-graph node padding")
    p.add_argument("--edges-per-graph", default=256, type=int,
                   help="dense layout: uniform per-graph edge padding")
    p.add_argument("--nodes-pad", default=8192, type=int)
    p.add_argument("--edges-pad", default=65536, type=int)
    p.add_argument("--question-len", default=32, type=int)
    p.add_argument("--program-len", default=16, type=int)
    p.add_argument("--full-answer-len", default=20, type=int)
    p.add_argument("--data-parallel", default=1, type=int,
                   help="data shards: ranks that train on batches of their "
                        "own; D x --edge-parallel must be WORLD_SIZE")
    p.add_argument("--edge-parallel", default=1, type=int,
                   help="edge shards per data shard: ranks that share a "
                        "batch, each holding its owned destinations' edges "
                        "(dense layout)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl on cuda, "
                        "gloo on cpu); gloo lets ranks share a card")
    p.add_argument("--steps-per-dispatch", default=1, type=int, metavar="K",
                   help="K optimizer steps per train-step call, over K "
                        "batches; the same as K single steps")
    p.add_argument("--program-loss", default="default",
                   choices=["default", "on", "off"],
                   help="override the config's program-CE loss term")
    p.add_argument("--rounds", default=None, type=int,
                   help="engine message-passing rounds (default: the "
                        "config's, 5)")
    p.add_argument("--use-execution-engine", action="store_true",
                   help="add the recurrent execution engine and its bitmap "
                        "loss")
    p.add_argument("--compile-cache", default="", metavar="DIR",
                   help="JAX's persistent compilation cache; does nothing "
                        "here: a step is a CUDA graph replayed per batch "
                        "shape, captured anew in each process")
    p.add_argument("--profile-dir", default="",
                   help="trace a few steps of the first epoch with "
                        "torch.profiler into DIR/trace.json, and turn on "
                        "the program's spans (gvqa.*, in that trace) and "
                        "device segments: each epoch and validation then "
                        "prints every segment's device ms per step")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype of the transformer and engine "
                        "products (parameters stay float32); default: the "
                        "config's, bfloat16")
    p.add_argument("--prng", default=None, choices=["rbg", "threefry"],
                   help="JAX's dropout PRNG; does nothing here (dropout "
                        "draws from a seeded torch.Generator)")
    p.add_argument("--dropout", type=float, default=None,
                   help="override every dropout rate (transformer stacks, "
                        "engine attention, classifier head) with one value")
    p.add_argument("--tiny", action="store_true",
                   help="debug-scale model widths (tests and smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default; raises without a "
                        "GPU) or cpu")
    return p


def _check_jax_flags(args) -> None:
    for flag, given in (("--compile-cache", args.compile_cache),
                        ("--prng", args.prng)):
        if given:
            print(f"{flag} names JAX machinery and does nothing here")


def _check_mesh(args, world: int) -> None:
    """Exit on a rank grid that does not fit the world or the layout."""
    n = args.data_parallel * args.edge_parallel
    if n != world:
        raise SystemExit(
            f"--data-parallel {args.data_parallel} x --edge-parallel "
            f"{args.edge_parallel} needs {n} ranks, have {world} "
            f"(WORLD_SIZE; launch with torchrun --nproc_per_node {n})")
    if args.edge_parallel > 1:
        if args.layout != "dense":
            raise SystemExit("--edge-parallel requires --layout dense")
        if args.nodes_per_graph % args.edge_parallel:
            raise SystemExit(
                f"--nodes-per-graph {args.nodes_per_graph} must be "
                f"divisible by --edge-parallel {args.edge_parallel}")


def _quiet_unless(main: bool) -> None:
    """Silence print() on every rank but rank 0 (the reference's
    setup_for_distributed)."""
    import builtins
    if not main:
        builtins.print = lambda *args, **kwargs: None


def _load_glove(args, text_vocab, sg_vocab, out_dir):
    """--glove as (text_matrix, sg_matrix): a .npy matrix as it is, or a
    GloVe text file scanned once per vocabulary and cached beside the
    checkpoints; rows missing from GloVe stay zero."""
    from graphvqa_tpu_torch.data.vocab import load_glove_matrix
    if not args.glove:
        return None, None
    path = pathlib.Path(args.glove)
    if path.suffix == ".npy":
        if not path.exists():
            if not args.glove_allow_missing:
                raise FileNotFoundError(
                    f"GloVe matrix not found: {path} — pass "
                    f"--glove-allow-missing to proceed with zero embeddings")
            return np.zeros((len(text_vocab), 300), np.float32), None
        sg_mat = None
        if args.glove_sg:
            sg_path = path.with_name(path.stem + "_sg.npy")
            sg_mat = np.load(sg_path) if sg_path.exists() else None
        return np.load(path), sg_mat

    def cached(name, vocab):
        cache = out_dir / name
        if cache.exists():
            return np.load(cache)
        mat = load_glove_matrix(vocab, path,
                                allow_missing=args.glove_allow_missing)
        np.save(cache, mat)
        return mat

    return (cached("glove_text.npy", text_vocab),
            cached("glove_sg.npy", sg_vocab) if args.glove_sg else None)


def build_config(args, text_vocab_size: int, sg_vocab_size: int):
    """The port's Config for these flags (``--model``'s configuration with
    the overrides the JAX CLI applies)."""
    from graphvqa_tpu_torch.config import BatchConfig, CONFIG_FACTORY
    cfg = CONFIG_FACTORY[args.model]()
    model_cfg = dataclasses.replace(
        cfg.model,
        text=dataclasses.replace(cfg.model.text, vocab_size=text_vocab_size),
        scene=dataclasses.replace(cfg.model.scene, vocab_size=sg_vocab_size),
        use_execution_engine=args.use_execution_engine,
        **({"dtype": args.dtype} if args.dtype else {}))
    if args.rounds:
        model_cfg = dataclasses.replace(model_cfg, engine=dataclasses.replace(
            model_cfg.engine, num_rounds=args.rounds))
    if args.tiny:
        model_cfg = dataclasses.replace(
            model_cfg,
            text=dataclasses.replace(model_cfg.text, emb_dim=48),
            scene=dataclasses.replace(model_cfg.scene, emb_dim=48),
            transformer=dataclasses.replace(
                model_cfg.transformer, hidden_dim=64, num_heads=4,
                ffn_dim=128, num_layers=2),
            classifier_hidden=64)
    if args.dropout is not None:
        model_cfg = dataclasses.replace(
            model_cfg,
            transformer=dataclasses.replace(model_cfg.transformer,
                                            dropout=args.dropout),
            engine=dataclasses.replace(model_cfg.engine, dropout=args.dropout),
            classifier_dropout=args.dropout)
    return dataclasses.replace(
        cfg, model=model_cfg,
        batch=BatchConfig(
            num_graphs=args.batch_size, nodes_pad=args.nodes_pad,
            edges_pad=args.edges_pad, question_len=args.question_len,
            program_len=args.program_len,
            full_answer_len=args.full_answer_len, layout=args.layout,
            nodes_per_graph=args.nodes_per_graph,
            edges_per_graph=args.edges_per_graph),
        train=dataclasses.replace(
            cfg.train, lr=args.lr, lr_drop=args.lr_drop, epochs=args.epochs,
            batch_size=args.batch_size, weight_decay=args.weight_decay,
            seed=args.seed, print_freq=args.print_freq,
            output_dir=str(args.output_dir),
            validate_every=args.validate_every,
            **({"use_bitmap_loss": True} if args.use_execution_engine
               else {}),
            **({} if args.program_loss == "default" else
               {"use_program_loss": args.program_loss == "on"})))


def _print_graphs(what, step, mesh) -> None:
    """The step's CUDA-graph calls so far (nothing for an eager step), on
    several ranks each rank's, gathered to rank 0 (every rank calls this
    at the same points, and its steps capture alike)."""
    from graphvqa_tpu_torch.parallel.collectives import all_gather_host
    graphs = getattr(step, "graphs", None)
    if graphs is None:
        return
    calls = (len(graphs.graphs), graphs.warm_ups, graphs.captures,
             sum(graphs.capture_seconds.values()), graphs.replays)
    ranks = (all_gather_host(calls, mesh.world_group) if mesh.size > 1
             else [calls])
    for r, (shapes, warm_ups, captures, seconds, replays) in enumerate(ranks):
        where = what if mesh.size == 1 else f"{what}, rank {r}"
        print(f"step graphs ({where}): {shapes} shapes, {warm_ups} warm-ups, "
              f"{captures} captures ({seconds:.2f}s), {replays} replays")


def _print_launches(what, before):
    """The hand-written kernels' launches since ``before``, a
    ``cuda_lib.launch_counts()`` reading, as they counted them on the card
    (replays of the step graphs too)."""
    from graphvqa_tpu_torch.ops import cuda_lib
    now = cuda_lib.launch_counts()
    print(f"kernel launches ({what}): " + ", ".join(
        f"{kind} {n - before[kind]}" for kind, n in now.items()))


def _print_segments(what) -> None:
    """Each device segment's ms per step since the last reset (tracing on:
    ``--profile-dir``), then a reset for the next report."""
    from graphvqa_tpu_torch.core import profiling
    if not profiling.enabled():
        return
    steps, seconds = profiling.read_segments()
    profiling.reset_segments()
    per = ", ".join(f"{name} {1e3 * s / max(steps, 1):.3f}"
                    for name, s in seconds.items() if s)
    print(f"device segments ({what}, ms per step over {steps} steps): "
          f"{per or 'none'}")


def _merged_meta(metas):
    """The metas of K batches as one: lists concatenated, counts summed."""
    merged = {k: [x for m in metas for x in m[k]]
              for k in metas[0] if isinstance(metas[0][k], list)}
    merged["real_count"] = sum(m["real_count"] for m in metas)
    return merged


def main(args):
    import torch

    import torch.distributed as dist

    from graphvqa_tpu_torch.core import profiling
    from graphvqa_tpu_torch.core.native import packer_name
    from graphvqa_tpu_torch.data import (
        GQADataset, build_scene_graph_vocab, build_text_vocab, tokenize)
    from graphvqa_tpu_torch.data.dataset import collate_stats
    from graphvqa_tpu_torch.data.prefetch import prefetch
    from graphvqa_tpu_torch.data.vocab import Vocab, load_answer_maps
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.models.pretrained import (
        inject_pretrained_embeddings)
    from graphvqa_tpu_torch.ops import cuda_lib
    from graphvqa_tpu_torch.parallel.data_parallel import make_dp_train_step
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_edge_eval_step, prepare_dp_edge_batch, prepare_edge_eval_batch)
    from graphvqa_tpu_torch.parallel.mesh import (
        data_seed, make_mesh, maybe_init_distributed)
    from graphvqa_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from graphvqa_tpu_torch.train.logging_utils import get_sha
    from graphvqa_tpu_torch.train.loop import (
        make_eval_step, make_train_step, train_one_epoch, validate)
    from graphvqa_tpu_torch.train.train_state import create_train_state

    _check_jax_flags(args)
    # the program's spans and segments follow --profile-dir, set before any
    # step is built so that every graph holds the stamps
    profiling.enable(bool(args.profile_dir))
    dev = maybe_init_distributed(args.device, args.dist_backend)
    _check_mesh(args, dist.get_world_size() if dist.is_initialized() else 1)
    mesh = make_mesh(args.data_parallel, args.edge_parallel)
    _quiet_unless(mesh.is_main)
    D, E = mesh.data, mesh.edge
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if mesh.is_main:
        logging.basicConfig(filename=out_dir / f"log-{args.model}.txt",
                            level=logging.INFO, force=True)
    stamp = f"git: {get_sha()}"
    print(stamp)
    logging.info(stamp)
    logging.info("args: %s", vars(args))

    root = pathlib.Path(args.data_root)

    def programs_path(split):
        return root / "questions" / f"{split}_programs.json"

    def scenes_path(split):
        name = "train" if "train" in split else "val"
        p = root / "sceneGraphs" / f"{name}_sceneGraphs.json"
        return p if p.exists() else None

    sg_vocab = build_scene_graph_vocab()
    vocab_path = out_dir / "text_vocab.json"
    saved_vocab = vocab_path.exists()
    if dist.is_initialized():
        dist.barrier()      # every rank looked before rank 0 writes
    if saved_vocab:
        text_vocab = Vocab.load(vocab_path)
    else:
        train_data = json.loads(programs_path(args.split).read_text())
        text_vocab = build_text_vocab(train_data, tokenize)
        if mesh.is_main:
            text_vocab.save(vocab_path)
    print(f"text vocab: {len(text_vocab)} | sg vocab: {len(sg_vocab)}")
    cfg = build_config(args, len(text_vocab), len(sg_vocab))

    model = build_model(cfg.model, device=dev, seed=args.seed)
    print(f"number of params: {sum(p.numel() for p in model.parameters())} "
          f"on {dev}")
    print(f"collate packer: {packer_name()}")
    _, label2ans = load_answer_maps()
    text_glove, sg_glove = _load_glove(args, text_vocab, sg_vocab, out_dir)
    if text_glove is not None or sg_glove is not None:
        inject_pretrained_embeddings(model, text_glove, sg_glove)
        nz = 0 if text_glove is None else int((text_glove != 0).any(1).sum())
        print(f"injected GloVe: {nz}/{len(text_vocab)} text rows non-zero"
              + (", sg rows injected" if sg_glove is not None else ""))

    state = create_train_state(model, lr=args.lr, lr_drop=args.lr_drop,
                               weight_decay=args.weight_decay,
                               clip_grad=args.clip_grad)
    start_epoch = args.start_epoch
    if args.resume:
        state, start_epoch = restore_checkpoint(args.resume, state)
        print(f"resumed from {args.resume} at epoch {start_epoch}")
    # seeded by the data rank: the edge ranks of a data index draw alike
    generator = torch.Generator(device=dev).manual_seed(
        data_seed(args.seed + 3, mesh))
    # LCGN's context features, seeded as the JAX CLI seeds 'lcgn_ctx'
    ctx_generator = torch.Generator(device=dev).manual_seed(
        data_seed(args.seed + 2, mesh))
    fast_validate = args.fast_validate or None
    # the steps replay CUDA graphs per batch shape, on every mesh
    # (train/graphs.py, parallel/data_parallel.py)
    eval_step = (make_edge_eval_step(model, cfg, mesh) if E > 1
                 else make_eval_step(model, cfg))
    val_ds = GQADataset(programs_path(args.val_split),
                        scenes_path(args.val_split), text_vocab, sg_vocab)

    def eval_batches(ds):
        """This data rank's shard of ``ds``'s batches, on the device."""
        for m, b in ds.iter_batches(cfg.batch, shard_index=mesh.data_rank,
                                    num_shards=D):
            if E > 1:
                b = prepare_edge_eval_batch(b, mesh)
            yield m, b.to(dev)

    if args.evaluate or args.evaluate_sets:
        for split in (args.evaluate_sets or [args.val_split]):
            ds = (val_ds if split == args.val_split else
                  GQADataset(programs_path(split), scenes_path(split),
                             text_vocab, sg_vocab))
            suffix = "" if split == args.val_split else f"_{split}"
            before = cuda_lib.launch_counts()
            res = validate(
                eval_step, eval_batches(ds), cfg, text_vocab=text_vocab,
                label2ans=label2ans,
                dump_path=(str(out_dir / f"dump_results{suffix}.json")
                           if args.dump_result else None),
                print_freq=args.print_freq,
                dump_attentions_path=(
                    str(out_dir / f"dump_attentions{suffix}.json")
                    if args.dump_attentions else None),
                scenes=ds.sg_data if args.dump_attentions else None,
                max_batches=fast_validate, print_qualitative=True,
                generator=ctx_generator, mesh=mesh)
            print(split, res)
            _print_launches(f"evaluate {split}", before)
            _print_segments(f"evaluate {split}")
            _print_graphs(f"evaluate {split}", eval_step, mesh)
        return

    train_ds = GQADataset(programs_path(args.split), scenes_path(args.split),
                          text_vocab, sg_vocab)
    # fill the caches before the worker pool forks, so workers inherit them
    t0 = time.perf_counter()
    train_ds.prewarm()
    print(f"dataset prewarm: {len(train_ds)} rows in "
          f"{time.perf_counter() - t0:.1f}s")

    K = max(args.steps_per_dispatch, 1)
    train_step = (make_dp_train_step(model, cfg, mesh, steps_per_dispatch=K)
                  if mesh.size > 1 else
                  make_train_step(model, cfg, steps_per_dispatch=K))

    def batches_fn(epoch):
        """This data rank's shard of the epoch, K batches per step."""
        it = train_ds.iter_batches(
            cfg.batch, shuffle=True, seed=args.seed + epoch, drop_last=True,
            shard_index=mesh.data_rank, num_shards=D,
            num_workers=args.workers, size_bucket_windows=args.size_bucket,
            permute_group=K)
        group, metas = [], []
        for m, b in it:
            group.append(b)
            metas.append(m)
            if len(group) < K:
                continue
            if E > 1:
                group = prepare_dp_edge_batch(group, mesh)
            group = [g.to(dev) for g in group]
            yield ((metas[0], group[0]) if K == 1
                   else (_merged_meta(metas), group))
            group, metas = [], []

    steps_per_epoch = len(train_ds) // D // (args.batch_size * K)
    for epoch in range(start_epoch, args.epochs):
        stats_before, before = dict(collate_stats), cuda_lib.launch_counts()
        state.epoch = epoch
        state = train_one_epoch(
            train_step, state, prefetch(batches_fn(epoch), depth=4),
            generator, epoch, print_freq=args.print_freq,
            num_batches=steps_per_epoch,
            engine_rounds=cfg.model.engine.num_rounds,
            profile_dir=((args.profile_dir or None)
                         if epoch == start_epoch else None),
            ctx_generator=ctx_generator)
        epoch_stats = {k: collate_stats[k] - stats_before[k]
                       for k in collate_stats}
        print(f"collate layout stats (this epoch): {epoch_stats}")
        _print_launches(f"train epoch {epoch}", before)
        _print_segments(f"train epoch {epoch}")
        _print_graphs(f"train epoch {epoch}", train_step, mesh)
        if (epoch + 1) % args.validate_every == 0:
            before = cuda_lib.launch_counts()
            res = validate(eval_step, eval_batches(val_ds), cfg,
                           text_vocab=text_vocab, label2ans=label2ans,
                           print_freq=args.print_freq,
                           max_batches=fast_validate, print_qualitative=True,
                           generator=ctx_generator, mesh=mesh)
            print(args.val_split, res)
            _print_launches(f"validate epoch {epoch}", before)
            _print_segments(f"validate epoch {epoch}")
            _print_graphs(f"validate epoch {epoch}", eval_step, mesh)
        if mesh.is_main:
            save_checkpoint(out_dir / "ckpt", state)
            print(f"checkpoint saved: {out_dir / 'ckpt'} (epoch {epoch})")
            # archival copies at the lr-drop and 100-epoch marks
            if (epoch + 1) % args.lr_drop == 0:
                save_checkpoint(out_dir / f"ckpt{epoch:04d}_lrdrop", state)
            elif (epoch + 1) % 100 == 0:
                save_checkpoint(out_dir / f"ckpt{epoch:04d}", state)
    train_ds.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser("GraphVQA (PyTorch)",
                                     parents=[get_args_parser()])
    main(parser.parse_args())
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
