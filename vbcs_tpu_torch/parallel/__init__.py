"""The distributed paths on ``torch.distributed``: the port of ``vbcs_tpu/parallel/``.

Each rank of a world holds a contiguous range of a pack's stripes on its
own device, plans the whole matrix on its host (``shard.py``, NumPy,
alike on every rank), runs the port's hand-written kernels on its shard
and meets the other ranks only through the collectives of ``comm.py``
(NCCL on the card, gloo on the CPU or for several ranks on one card; the
caller names the backend).  ``comm.run_ranks`` starts a world of
processes.  :data:`COUNTERPARTS` names, for every public function of the
JAX modules and of ``__graft_entry__.py``, the port's function that does
its work: the 2-D and the column-stripe JAX modules map onto
``stream.py``'s functions (the latter with ``shard_stream(...,
balance="even")``), which take 1-D and 2-D packs alike.
"""

COUNTERPARTS = {
    "vbcs_tpu.parallel.spmv.block_specs": "vbcs_tpu_torch.parallel.spmv.shard_vbc",
    "vbcs_tpu.parallel.spmv.shard_vbc": "vbcs_tpu_torch.parallel.spmv.shard_vbc",
    "vbcs_tpu.parallel.spmv.dist_tr_spmv": "vbcs_tpu_torch.parallel.spmv.dist_tr_spmv",
    "vbcs_tpu.parallel.spmv.dist_spmv": "vbcs_tpu_torch.parallel.spmv.dist_spmv",
    "vbcs_tpu.parallel.spmv.dist_tr_spmm": "vbcs_tpu_torch.parallel.spmv.dist_tr_spmm",
    "vbcs_tpu.parallel.spmv.dist_spmm": "vbcs_tpu_torch.parallel.spmv.dist_spmm",
    "vbcs_tpu.parallel.pallas_spmv.shard_stream":
        "vbcs_tpu_torch.parallel.stream.shard_stream",
    "vbcs_tpu.parallel.pallas_spmv.place": "vbcs_tpu_torch.parallel.stream.shard_stream",
    "vbcs_tpu.parallel.pallas_spmv.dist_tr_spmv_pallas":
        "vbcs_tpu_torch.parallel.stream.dist_tr_spmv_replicated",
    "vbcs_tpu.parallel.pallas_spmv.plan_halo": "vbcs_tpu_torch.parallel.shard.plan_halo",
    "vbcs_tpu.parallel.pallas_spmv.dist_tr_spmv_pallas_halo":
        "vbcs_tpu_torch.parallel.stream.dist_tr_spmv_halo",
    "vbcs_tpu.parallel.pallas_spmv.plan_overlap":
        "vbcs_tpu_torch.parallel.shard.plan_overlap",
    "vbcs_tpu.parallel.pallas_spmv.dist_tr_spmv_pallas_halo_overlap":
        "vbcs_tpu_torch.parallel.stream.dist_tr_spmv_halo_overlap",
    "vbcs_tpu.parallel.pallas_spmv2d.shard_stream_2d":
        "vbcs_tpu_torch.parallel.stream.shard_stream",
    "vbcs_tpu.parallel.pallas_spmv2d.place_2d":
        "vbcs_tpu_torch.parallel.stream.shard_stream",
    "vbcs_tpu.parallel.pallas_spmv2d.dist_tr_spmv_pallas_2d":
        "vbcs_tpu_torch.parallel.stream.dist_tr_spmv_replicated",
    "vbcs_tpu.parallel.pallas_spmv2d.plan_halo_2d":
        "vbcs_tpu_torch.parallel.shard.plan_halo",
    "vbcs_tpu.parallel.pallas_spmv2d.dist_tr_spmv_pallas_2d_halo":
        "vbcs_tpu_torch.parallel.stream.dist_tr_spmv_halo",
    "vbcs_tpu.parallel.pallas_spmv3.shard_oneshot3":
        "vbcs_tpu_torch.parallel.stream.shard_stream",
    "vbcs_tpu.parallel.pallas_spmv3.place3": "vbcs_tpu_torch.parallel.stream.shard_stream",
    "vbcs_tpu.parallel.pallas_spmv3.dist_tr_spmv_oneshot3":
        "vbcs_tpu_torch.parallel.stream.dist_tr_spmv_replicated",
    "__graft_entry__.entry": "vbcs_tpu_torch.entry.entry",
    "__graft_entry__.dryrun_multichip": "vbcs_tpu_torch.entry.dryrun_multichip",
}
