"""Share of the traced sub-window's device-busy time of the train cell that
PyTorch's row gather and row sum kernels take: ``index_select`` (forward
gathers, the backward of ``index_add_``) and ``index_add_`` (per-destination
sums, the backward of ``index_select``), whatever calls them. In a GINE cell
that is chiefly the engine's 812-wide message gather and its sum per
destination, forward and backward; the scene encoder's MetaLayer, the
embeddings' lookups and the loss's ``gather`` launch the same kernels on
narrower rows.

The kernels, by the names the profiler gives them on the card (ATen's
``Indexing.cu`` and ``ScatterGatherKernel.cu``; template arguments vary
with dtype, index width and row alignment). Read in a traced run of
``gine.train.gqa_b200`` (NVIDIA H100, PyTorch 2.11), ms per step:
  * ``at::native::indexFuncLargeIndex<float, ...ReduceAdd>`` 1.83 (the
    float32 sums) and ``<c10::BFloat16, ...ReduceAdd>`` 1.66 (the gathers'
    backward into bfloat16 rows);
  * ``at::native::vectorized_gather_kernel<16, int>`` 0.55: ``index_select``
    of rows whose bytes are a multiple of 16;
  * ``at::native::_scatter_gather_elementwise_kernel<...TensorAssign>``
    0.55: ``index_select`` of other rows (812 bfloat16 values are 1,624
    bytes) and ``gather``; its ``ReduceAdd`` form (``scatter_add``) 0.01.
``indexSelectLargeIndex`` / ``indexSelectSmallIndex`` and
``indexFuncSmallIndex`` (other shapes and index counts) did not appear and
are counted should they. None when the trace holds none of them."""

KERNELS = ("indexFuncLargeIndex", "indexFuncSmallIndex",
           "vectorized_gather_kernel", "_scatter_gather_elementwise_kernel",
           "indexSelectLargeIndex", "indexSelectSmallIndex")


def read(run):
    if run.mode != "train" or not run.trace or not run.trace["busy_s"]:
        return None
    spent = sum(v for k, v in run.trace["kernel_s"].items()
                if any(name in k for name in KERNELS))
    if not spent:
        return None
    return 100.0 * spent / run.trace["busy_s"]
