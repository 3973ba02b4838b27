#!/usr/bin/env python3
"""Time variants of the GAT-round backward kernel against each other, on the
card, in one process.

    python3 tools/time_gat_backward_variants.py VARIANTS.json

VARIANTS.json maps a variant's name to either a list of [old, new] text
replacements applied to graphvqa_tpu_torch/csrc/gat_round_backward.cu, or
the path of a whole source file (an empty list is the committed kernel).
Each variant is written to build/variants/ (gitignored), all are built with
nvcc for sm_90a in parallel, and each is launched on chip_smoke.py's phase-3
batch (B=512, npg=64, epg=256, H=4, C=300, 'graph' shift, with the share and
the dropout scale) in bf16 and f32. It prints each build's registers and
spills, its SASS instruction count per kernel, and the median device time of
15 launches (CUDA events around each launch), with the L2 flushed before
each launch (cold) and without (warm). Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "graphvqa_tpu_torch" / "csrc" / "gat_round_backward.cu"
OUT = ROOT / "build" / "variants"


def make(name: str, spec) -> pathlib.Path:
    """The variant's source file under build/variants/."""
    if isinstance(spec, str):
        text = pathlib.Path(spec).read_text()
    else:
        text = SRC.read_text()
        for old, new in spec:
            if old not in text:
                sys.exit(f"variant {name}: text not found: {old[:80]!r}")
            text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def sass_sizes(lib: pathlib.Path, cuobjdump: str) -> list[int]:
    """SASS instructions of each kernel in the library."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    sizes = []
    for line in text.splitlines():
        if "Function :" in line:
            sizes.append(0)
        elif sizes and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            sizes[-1] += 1
    return sizes


def build(sources: dict) -> dict:
    """nvcc for sm_90a on each {name: source path}, all in parallel, into
    build/variants/ -> {name: library path} of the builds that succeeded;
    prints each build's registers, spills and SASS size."""
    sys.path.insert(0, str(ROOT))
    from graphvqa_tpu_torch.ops import gat_round as gr
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = gr._nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    jobs = {}
    for name, src in sources.items():
        lib = OUT / f"lib{name}.so"
        jobs[name] = (subprocess.Popen(
            [nvcc, *gr._NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"[{name}] nvcc failed:\n{text[-3000:]}", flush=True)
            continue
        regs = sorted(set(re.findall(r"Used (\d+) registers", text)))
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", text)))
        print(f"[{name}] registers {'/'.join(regs)}, spill stores "
              f"{'/'.join(spills)} bytes, SASS instructions per kernel "
              f"{sass_sizes(lib, cuobjdump)}", flush=True)
        libs[name] = lib
    return libs


def phase3_launcher(lib_path, dtype, shift="graph"):
    """-> a function that launches the library's kernel once on
    chip_smoke.py's phase-3 batch (with the share and the dropout scale) on
    the current stream, and the library."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from graphvqa_tpu_torch.ops import gat_round as gr
    dev = torch.device("cuda", 0)
    inp = cs.kernel_inputs(dev)
    keep = cs.keep_scale(inp, seed=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    grad = torch.randn(cs.B * cs.NPG, cs.C, generator=gen,
                       device=dev).to(dtype)
    xw, ins = inp["xw32"].to(dtype), inp["ins32"].to(dtype)
    N = cs.B * cs.NPG
    outs = (torch.empty_like(xw), torch.empty(N, cs.H, device=dev),
            torch.empty(N, cs.H, device=dev),
            torch.empty(cs.B, cs.EPG, cs.H, device=dev), torch.empty_like(ins))
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gat_round_backward_launch.argtypes = (
        [ci] + [vp] * 17 + [ci] * 5 + [cf, ci, vp])
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.gat_round_backward_launch(
            gr._DTYPES[dtype], *(inp[k].data_ptr() for k in (
                "dl", "sl", "mask", "al", "ar", "ae")),
            keep.data_ptr(), None, xw.data_ptr(), ins.data_ptr(),
            grad.data_ptr(),
            *(t.data_ptr() for t in outs), counter.data_ptr(), cs.B, cs.NPG,
            cs.EPG, cs.H, cs.C, 0.2, int(shift == "graph"), stream)
        if err:
            sys.exit(f"{lib_path.name}: launch failed: CUDA error {err}")
    return launch, lib


def main() -> None:
    variants = json.loads(pathlib.Path(sys.argv[1]).read_text())
    import torch
    if not torch.cuda.is_available():
        sys.exit("time variants: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    OUT.mkdir(parents=True, exist_ok=True)
    libs = build({name: make(name, spec) for name, spec in variants.items()})
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for name, path in libs.items():
        row = []
        for dtype in (torch.bfloat16, torch.float32):
            launch, _ = phase3_launcher(path, dtype)

            def median_us(cold):
                times = []
                for _ in range(15):
                    if cold:
                        flush.zero_()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    launch()
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b) * 1e3)
                return statistics.median(times)

            launch()
            torch.cuda.synchronize()
            row.append(f"{str(dtype)[6:]} {median_us(True):.2f}us cold-L2 "
                       f"({median_us(False):.2f} warm)")
        print(f"[time] {name:16s} " + "  ".join(row), flush=True)


if __name__ == "__main__":
    main()
