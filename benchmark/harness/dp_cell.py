"""A training cell over several ranks, one process and one card each, as
``torchrun`` launches the port's CLI with ``--data-parallel N``: this
process is rank 0 and starts the others, which run the same training cell
(``train_cell.run`` with a ``Ranks``) on their own shards and end with it.
Rank 0 reports: the questions of every rank, its own window, data wait,
trace and memory, and the check of the step's first three steps against
the reference meaning every rank's gradient.

The process group is given its address (``tcp://localhost:<port>``),
world size and rank; NCCL on the card, gloo on the CPU (tests).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pathlib
import socket
import time

import torch

from harness import common, train_cell


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def join(rank: int, world: int, ports, device_type: str):
    """Join the group as ``rank`` -> (device, Ranks)."""
    import torch.distributed as dist
    from graphvqa_tpu_torch.parallel.mesh import make_mesh
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
        # ranks sharing the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{ports[0]}",
                            world_size=world, rank=rank)
    store = dist.TCPStore("localhost", ports[1], world, rank == 0)
    return device, train_cell.Ranks(make_mesh(world, 1), store)


class Share:
    """Hands rank 0's traffic directory to the other ranks (``prepare``)."""

    def __init__(self, ranks):
        self.rank, self.store = ranks.rank, ranks.store

    def publish(self, path) -> None:
        self.store.set("traffic_dir", str(path))

    def receive(self) -> pathlib.Path:
        self.store.wait(["traffic_dir"])
        return pathlib.Path(self.store.get("traffic_dir").decode())


def leave(ranks) -> None:
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def rank_main(rank, world, ports, device_type, cfg_file, traffic, seed,
              seconds, trace, hooks):
    """Ranks 1..N-1: set up, train over the window, leave."""
    from harness import cell as cell_mod
    device, ranks = join(rank, world, ports, device_type)
    cfg = cell_mod.port_config(cfg_file, traffic)
    s = common.prepare(cfg, cfg_file, traffic, seed, Share(ranks))
    try:
        train_cell.run(s, seed, seconds, False, device, time.perf_counter(),
                       hooks, ranks)
    finally:
        common.cleanup(s, owner=False)
    leave(ranks)


def run(cfg_file, traffic, seed, seconds, trace, device, t_start,
        hooks=None):
    """Rank 0's run -> (Window, Setup); the other ranks have ended."""
    from harness import cell as cell_mod
    world = traffic["ranks"]
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"{world} ranks need {world} cards")
    ports = (free_port(), free_port())
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(
        r, world, ports, device.type, cfg_file, traffic, seed, seconds,
        trace, hooks)) for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        device, ranks = join(0, world, ports, device.type)
        cfg = cell_mod.port_config(cfg_file, traffic)
        s = common.prepare(cfg, cfg_file, traffic, seed, Share(ranks))
        try:
            out = train_cell.run(s, seed, seconds, trace, device, t_start,
                                 hooks, ranks)
        finally:
            common.cleanup(s)
        leave(ranks)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks ended with codes {bad}")
    return out, s
