#!/usr/bin/env python3
"""Where the GAT-round backward kernel's cycles go, on the card.

    python3 tools/stamp_gat_backward.py [--dtype bfloat16] [--shift graph]

Copies graphvqa_tpu_torch/csrc/gat_round_backward.cu (or --source, a
variant of it) into build/variants/ (gitignored) with a clock64() stamp before
each numbered phase comment of the kernel's work loop ("// 1. ...", and
sub-phases "// 4b. ..." where a variant marks them) and at the loop's end,
builds the copy with nvcc for sm_90a, runs it once on chip_smoke.py's phase-3
batch (B=512, npg=64, epg=256, H=4, C=300, with the share and the dropout
scale) and prints, from thread 0 of every block: each phase's share of all
blocks' cycles, the mean and largest block's cycles, and the work units each
block took. The committed kernel is not changed. Needs an NVIDIA GPU and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "graphvqa_tpu_torch" / "csrc" / "gat_round_backward.cu"
OUT = ROOT / "build" / "variants"
MAX_BLOCKS = 4096
PHASES = 24    # room for the phase comments and the loop's exit
MARKER = re.compile(r"\s+// (\d+[a-z]?)\. (.*)")

PRELUDE = f"""
__device__ unsigned long long g_cycles[{MAX_BLOCKS}][{PHASES}];
__device__ unsigned long long g_total[{MAX_BLOCKS}];
__device__ int g_units[{MAX_BLOCKS}];
// thread 0 sums each phase's cycles in a local array (constant indices,
// so registers or L1) and writes them out once, at the loop's exit
#define STAMP(k) do {{ const long long t_ = clock64(); \\
  if (threadIdx.x == 0) s_cyc[k] += t_ - t_prev; t_prev = t_; }} while (0)
"""
EPILOGUE = f"""
extern "C" int stamps_read(unsigned long long* cycles,
                           unsigned long long* total, int* units) {{
  cudaMemcpyFromSymbol(cycles, g_cycles, sizeof(g_cycles));
  cudaMemcpyFromSymbol(total, g_total, sizeof(g_total));
  return (int)cudaMemcpyFromSymbol(units, g_units, sizeof(g_units));
}}
extern "C" int stamps_reset() {{
  static unsigned long long zc[{MAX_BLOCKS}][{PHASES}], zt[{MAX_BLOCKS}];
  static int zu[{MAX_BLOCKS}];
  cudaMemcpyToSymbol(g_cycles, zc, sizeof(zc));
  cudaMemcpyToSymbol(g_total, zt, sizeof(zt));
  return (int)cudaMemcpyToSymbol(g_units, zu, sizeof(zu));
}}
"""


def instrument(text: str) -> tuple[str, list[str]]:
    """The kernel source with stamps, and the phases' names: phase k's
    cycles run from its comment to the next phase's comment (the loop's end
    for the last phase); the last slot is the loop's exit."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if "gat_round_backward_kernel(const Params p)" in ln)
    body_end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    out = lines[:start + 2]
    out.append("  long long t_prev = clock64(); const long long t_start = "
               f"t_prev; long long s_cyc[{PHASES}] = {{}};")
    names = []
    for i in range(start + 2, body_end):
        ln = lines[i]
        m = MARKER.match(ln)
        if m:
            if names:
                out.append(f"    STAMP({len(names) - 1});")
            if len(names) == 1:
                out.append("    if (threadIdx.x == 0) "
                           "g_units[blockIdx.x] += 1;")
            names.append(f"{m.group(1)} {m.group(2)[:60]}")
        if ln.strip() == "if (unit >= units) break;":
            out.append(f"    if (unit >= units) {{ STAMP({PHASES - 1}); "
                       "if (threadIdx.x == 0) { g_total[blockIdx.x] = "
                       f"clock64() - t_start; for (int k_ = 0; k_ < {PHASES}; "
                       "++k_) g_cycles[blockIdx.x][k_] = s_cyc[k_]; } "
                       "break; }")
            continue
        out.append(ln)
        if lines[i + 1] == "  }" and lines[i + 2] == "}":
            out.append(f"    STAMP({len(names) - 1});")
    if not names or not names[0].startswith("0 ") or \
            len(names) >= PHASES:
        sys.exit(f"stamp: unexpected phase comments {names}")
    out.extend(lines[body_end:])
    text = "\n".join(out) + "\n"
    anchor = "namespace {"
    return (text.replace(anchor, PRELUDE + anchor, 1) + EPILOGUE,
            names + ["exit"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--shift", default="graph")
    ap.add_argument("--source", type=pathlib.Path, default=SRC)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("stamp: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "tools"))
    from time_gat_backward_variants import build, phase3_launcher

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{args.source.stem}_stamped.cu"
    text, names = instrument(args.source.read_text())
    src.write_text(text)
    libs = build({f"{args.source.stem}_stamped": src})
    if not libs:
        sys.exit("stamp: the instrumented copy did not build")
    launch, lib = phase3_launcher(next(iter(libs.values())),
                                  getattr(torch, args.dtype), args.shift)
    launch()                                   # warm-up
    torch.cuda.synchronize()
    lib.stamps_reset()
    launch()
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * (MAX_BLOCKS * PHASES))()
    total = (ctypes.c_ulonglong * MAX_BLOCKS)()
    units = (ctypes.c_int * MAX_BLOCKS)()
    lib.stamps_read(cycles, total, units)
    blocks = [i for i in range(MAX_BLOCKS) if total[i]]
    per_phase = [sum(cycles[i * PHASES + k] for i in blocks)
                 for k in range(PHASES)]
    grand = sum(per_phase)
    tot = [total[i] for i in blocks]
    took = [units[i] for i in blocks]
    print(f"[stamps] {args.source.name} {args.dtype} shift={args.shift}: "
          f"{len(blocks)} blocks, units per block min {min(took)} mean "
          f"{sum(took) / len(took):.2f} max {max(took)}; block cycles mean "
          f"{sum(tot) / len(tot):.0f} max {max(tot)} "
          f"({max(tot) / (sum(tot) / len(tot)):.2f}x mean)")
    slots = list(range(len(names) - 1)) + [PHASES - 1]
    for name, k in zip(names, slots):
        print(f"[stamps]   {100 * per_phase[k] / grand:5.1f} %  {name}")


if __name__ == "__main__":
    main()
