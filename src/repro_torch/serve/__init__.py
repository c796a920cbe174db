"""Serving: batched prefill/decode engine, paged KV allocator, n:m
compressed decode weights, and fault-supervised recovery (port of
``repro.serve``)."""
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
from repro_torch.serve.compressed import (CompressionDowngrade,
                                          compress_params, decompress_params)
from repro_torch.serve.faults import (DeviceOom, EngineDown, EngineFault,
                                      FaultPlan, FaultSpec, InjectedFault,
                                      NonFiniteLogits, QueueFull,
                                      SnapshotWriteError,
                                      StepDeadlineExceeded)
from repro_torch.serve.pager import (Pager, PagePool, PagerAuditError,
                                     PoolExhausted, PrefixCache)
from repro_torch.serve.supervisor import Supervisor, SupervisorConfig

__all__ = [
    "Request", "ServeConfig", "ServingEngine",
    "CompressionDowngrade", "compress_params", "decompress_params",
    "Pager", "PagePool", "PagerAuditError", "PoolExhausted", "PrefixCache",
    "FaultPlan", "FaultSpec", "EngineFault", "InjectedFault", "DeviceOom",
    "NonFiniteLogits", "StepDeadlineExceeded", "SnapshotWriteError",
    "EngineDown", "QueueFull",
    "Supervisor", "SupervisorConfig",
]
