"""The port's kernels and their plain versions.

``CALL_LAUNCHERS`` holds the launchers an operator call can run, one
launch each (the chain: one for every ``MAX_LAUNCH_ITERS`` iterations;
the ordered scatter: its products launch and, where a row of Y has no
block or several, its rows launch); ``utils.trace.launches`` sums their
``.launches`` counters.
"""

from .chain import tr_spmv_chain
from .ordered import mul_ordered
from .scatter import tr_spmv_scatter
from .spmm import tr_spmm
from .trspmv import tr_spmv
from .trspmv2d import tr_spmv_2d

CALL_LAUNCHERS = (tr_spmv, tr_spmv_scatter, tr_spmv_2d, tr_spmm, tr_spmv_chain,
                  mul_ordered)
