from repro_torch.serverless.backends import (
    BACKEND_NAMES, BACKENDS, BackendRunInfo, DrainState, ExecutionBackend,
    InlineBackend, PoolConfig, RunReport, Segment, WorkRequest,
    make_backend,
)
from repro_torch.serverless.cost import (
    Bill, BillingRecord, speedup_of, USD_PER_GB_S,
)
from repro_torch.serverless.ledger import TaskLedger

__all__ = [
    "Bill", "BillingRecord", "speedup_of", "USD_PER_GB_S", "PoolConfig",
    "RunReport", "TaskLedger", "ExecutionBackend",
    "BackendRunInfo", "DrainState", "InlineBackend",
    "WorkRequest", "Segment", "BACKENDS", "BACKEND_NAMES",
    "make_backend",
]
