"""Share of the traced sub-window's device-busy time of the train cell that
cuBLAS's float32 GEMM kernels take, forward and backward, whatever calls
them. In every cell the Transformer stacks' attention products (scores
and weighted sums, ``nn/transformer.py``) run as such; on top of them a
GCN cell's rounds each project ``matmul_f32([h ; ins], W)``, 812 -> 300
over every padded node row, and multiply the per-graph ``P @ xw`` of the
degree-normalized sum, and a GAT cell's rounds their node and edge
projections (``matmul_f32`` too). The hand-written kernels (the GAT, GINE
and LCGN pairs) are not cuBLAS's and are not counted.

The kernels, by the names the profiler gives them on the card (cuBLAS's
float32 kernels with TF32 off; tile sizes and layouts vary with the
shapes). Read in traced runs with the program's tracing on (NVIDIA H100,
PyTorch 2.11), ms per step:
  * ``sm80_xmma_gemm_f32f32_f32f32_f32_{tn,nn,nt}_n_tilesize...ffma...``:
    gcn.train.gqa_b200 4.2 in eleven tile shapes (128x64 0.79 + 0.74, 32x32
    0.53 + 0.49 + 0.09, 32x64 0.42 + 0.37 + 0.34, 64x32 0.33, 64x64 0.10 +
    0.10), gat.train.gqa_b200 4.1 (64x64 1.26, 128x64 1.21, 32x32 0.49,
    32x64 0.37, the rest under 0.2 each, split-k forms included);
  * ``cutlass::Kernel2<cutlass_80_simt_sgemm_...>``: gcn 0.81 (64x128 nt),
    gat 1.86 (128x64 nt 1.84, 128x32 nn 0.02);
  * ``gemmSN_{NN,TN}_kernel<float, ...>``, cuBLAS's small-n GEMMs: 0.04 in
    both; their bfloat16 instances are not counted.
Sums: gcn 5.1 of 37.2 busy ms, gat 6.1 of 36.1; in other traced runs of
the same build gcn 5.34 of 38.08 (14.0 %), gine 2.67 of 37.19 (7.2 %) and
lcgn 3.59 of 51.77 (6.9 %), which is the attention's products with lcgn's
command linears and P @ xw. GCN's projections alone at the cell's shapes
(12,800 x 812 -> 300, five rounds) take 2.38 ms a step in three of the
names above (forward ``..._nn_n_tilesize128x64...`` 0.75, dx
``cutlass_80_simt_sgemm_64x128_8x5_nt`` 0.82, dW ``..._tn_n_tilesize128x64...``
0.80) and its ``P @ xw`` 0.34 more: gcn's share less gine's. None when the
trace holds none of them."""

KERNELS = ("gemm_f32f32_f32f32_f32", "simt_sgemm", "gemmSN_NN_kernel<float,",
           "gemmSN_TN_kernel<float,")


def read(run):
    if run.mode != "train" or not run.trace or not run.trace["busy_s"]:
        return None
    spent = sum(v for k, v in run.trace["kernel_s"].items()
                if any(name in k for name in KERNELS))
    if not spent:
        return None
    return 100.0 * spent / run.trace["busy_s"]
