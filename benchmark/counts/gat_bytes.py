"""The fewest bytes one launch of a GAT-round kernel must move, for any
rung of the dense ladder and the real counts of the batch it runs on: the
benchmark's copy of ``chip_smoke.py``'s ``least_bytes`` and
``backward_least_bytes``, generalised from the (64, 256) rung and one
fixed batch.

Forward: every input element the result depends on read once (the xw and
alpha_l rows of distinct real sources, the alpha_r rows of distinct real
destinations, the alpha_e rows and, in training, the dropout scale of real
edges, the local indices and the edge mask in full, ins in full), and the
output written once in full. Padded node rows of xw are never read.

Backward: the forward's inputs the gradients depend on read once (the
indices and mask in full, xw and alpha_l rows of distinct real sources,
alpha_r and upstream-gradient rows of distinct real destinations, the
alpha_e and dropout-scale rows of real edges, ins in full), and every
gradient written once in full (d_xw, d_alpha_l and d_alpha_r, d_alpha_e,
d_ins).
"""
from __future__ import annotations

F32 = 4


def forward_bytes(B, npg, epg, H, C, elem, n_src, n_dst, n_edges,
                  with_ins=True, with_keep=False) -> int:
    return (n_src * H * C * elem + n_src * H * F32 + n_dst * H * F32
            + n_edges * H * F32 * (2 if with_keep else 1) + 3 * B * epg * F32
            + (B * H * C * elem if with_ins else 0) + B * npg * C * elem)


def backward_bytes(B, npg, epg, H, C, elem, n_src, n_dst, n_edges,
                   with_keep=True) -> int:
    reads = (3 * B * epg * F32 + n_src * H * C * elem + n_src * H * F32
             + n_dst * H * F32 + n_dst * C * elem
             + n_edges * H * F32 * (2 if with_keep else 1) + B * H * C * elem)
    writes = (B * npg * H * C * elem + 2 * B * npg * H * F32
              + B * epg * H * F32 + B * H * C * elem)
    return reads + writes
