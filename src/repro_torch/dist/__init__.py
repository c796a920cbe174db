"""Distribution layer on ``torch.distributed`` (port of ``repro.dist``).

* ``sharding``    — PartitionSpec derivation for the ("data", "model")
  production mesh: TP rules (param_pspecs), FSDP+TP (fsdp_pspecs), batch
  and KV-cache layouts, and their DTensor placements (shard_params).
  Divisibility-aware: any dim a mesh axis does not divide falls back to
  replication.
* ``prune``       — ``prune_layer_sharded``: rows of W split over the
  mesh's ranks, Hessian replicated, per-row block-wise solves, rows
  all-gathered; ``hessian_all_reduce`` for data-parallel calibration.
* ``compression`` — int8 gradient compression with error feedback for the
  cross-pod all-reduce.
"""
from repro_torch.dist import compression, prune, sharding  # noqa: F401
