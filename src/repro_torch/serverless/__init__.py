from repro_torch.serverless.autoscale import (
    AutoscaleDecision, OccupancyAutoscaler, TopologyAutoscaler,
)
from repro_torch.serverless.backends import (
    BACKEND_NAMES, BACKENDS, BackendRunInfo, DrainState, ExecutionBackend,
    InlineBackend, PoolConfig, RunReport, Segment, ShardedBackend,
    WaveBackend, WorkRequest, make_backend,
)
from repro_torch.serverless.cost import (
    Bill, BillingRecord, speedup_of, USD_PER_GB_S,
)
from repro_torch.serverless.dispatch import (
    DispatchQueue, DispatchStats, PendingBucket,
)
from repro_torch.serverless.ledger import TaskLedger
from repro_torch.serverless.topology import (
    HostMesh, Topology, TopologyBackend, TopologyInfo,
)

__all__ = [
    "AutoscaleDecision", "OccupancyAutoscaler", "TopologyAutoscaler",
    "Bill", "BillingRecord", "speedup_of", "USD_PER_GB_S", "PoolConfig",
    "RunReport", "TaskLedger", "ExecutionBackend",
    "BackendRunInfo", "DrainState", "InlineBackend", "WaveBackend",
    "ShardedBackend", "WorkRequest", "Segment", "BACKENDS", "BACKEND_NAMES",
    "make_backend",
    "DispatchQueue", "DispatchStats", "PendingBucket",
    "HostMesh", "Topology", "TopologyBackend", "TopologyInfo",
]
