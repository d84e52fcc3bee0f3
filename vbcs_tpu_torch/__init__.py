"""vbcs_tpu_torch — variable-block sparse linear algebra in PyTorch + CUDA.

The port of ``vbcs_tpu`` (JAX/Pallas on TPU) to one NVIDIA H100.  It
keeps the JAX package's layout, so each module has its counterpart
there:

* ``formats``  — CSC ingest, the host ``VBC1D``/``VBC2D`` (exact NumPy
  oracles), and ``VBC1DDevice``/``VBC2DDevice``/``ScatterDevice``, their
  arrays on a torch device, with ``SemiringDevice``, a pack's stored
  values flat in any dtype;
* ``plan``     — chunkers, the ``DynamicTotalChunker`` optimal DP (on
  the host, and ``dp_partition_device`` on a torch device), the
  ``AlternatingPacker`` 2-D planner, the row and symmetric reorderings
  and the locality estimate;
* ``models``   — the 1-D and 2-D cost models and the autotuned time
  models, fit on the card;
* ``ops``      — the hand-written CUDA kernels (``csrc/``) with their
  plain PyTorch versions (the products, and the DP's cost table and
  recurrence), the semiring SpMV/SpMM in any dtype and the CSC baseline;
* ``native``   — ctypes bindings to the C++ host paths (the port's own
  copy of the JAX package's source);
* ``operator`` — ``VBCOperator`` (``tr_mul``/``mul``, ``tr_mul_chain``,
  ``tr_mul_mat``/``mul_mat``) and ``VBC2DOperator``;
* ``probes``   — micro-probes of the kernels on the card (ports of
  ``bench_tools/probe_*.py``, each on a kernel of its own) and the host
  stages' timings (``probe_pack``);
* ``tools``    — the method table (``python -m
  vbcs_tpu_torch.tools.method_table``), the distributed weak-scaling
  rows (``python -m vbcs_tpu_torch.tools.weak_scaling``) and the JAX
  bench's four matrices;
* ``utils``    — CUDA-event timing and the roofline and trace helpers.

Importing this package loads no JAX.  Devices are never picked
implicitly: every constructor that places tensors takes ``device``.
"""

from .api import default_1d_partitioner, default_2d_partitioner, vbc1d, vbc2d
from .formats.csc import CSC
from .formats.device import ScatterDevice, SemiringDevice, VBC1DDevice, VBC2DDevice
from .formats.partition import MapPartition, SplitPartition
from .formats.vbc1d import VBC1D, pack_1dvbc
from .formats.vbc2d import VBC2D, pack_vbc2d
from .models.cost import (
    AffineConnectivityModel,
    AffineFillNetCostModel,
    BlockComponentCostModel,
    ColumnBlockComponentCostModel,
    ConstrainedCost,
    Line,
    VertexCount,
    model_1dvbc_blocks,
    model_1dvbc_memory,
    model_vbc_blocks,
    model_vbc_memory,
    row_component_value,
    total_value,
)
from .models.autotune import (
    autotune_1dvbc_trspmv,
    autotune_vbc_trspmv,
    model_1dvbc_trspmv_time,
    model_vbc_trspmv_time,
)
from .operator import (
    VBC2DOperator,
    VBCOperator,
    forward_bytes,
    forward_pack,
    mean_tile_height,
    route_tr_spmv,
    route_tr_spmv_2d,
    tile2d_worthwhile,
)
from .ops.csr import CSCDevice, csc_spmv, csc_tr_spmv
from .ops.chain import tr_spmv_chain, tr_spmv_chain_plain
from .ops.gather import gather, gather_plain, gather_tiles, gather_tiles_plain
from .ops.ordered import mul_ordered, mul_ordered_plain
from .ops.relayout import tile_relayout, tile_relayout_plain
from .ops.scatter import tr_spmv_scatter, tr_spmv_scatter_plain
from .ops.spmm import tr_spmm, tr_spmm_plain
from .ops.trspmv import tr_spmv, tr_spmv_plain
from .ops.trspmv2d import tr_spmv_2d, tr_spmv_2d_plain
from .plan.alternating import (
    AlternatePacker,
    AlternatingPacker,
    pack_plaid,
    pack_stripe,
)
from .plan.chunkers import EquiChunker, OverlapChunker, StrictChunker
from .plan.dynamic import DynamicTotalChunker
from .plan.device_dp import dp_partition_device, dp_partition_device_2d
from .plan.reorder import profile_rows, rcm_rows, rcm_symmetric, window_badness

__version__ = "0.1.0"
