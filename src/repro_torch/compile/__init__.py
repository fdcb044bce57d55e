"""The megabatch task compiler.

Lowers the union of all pending WorkRequests into a small set of bucketed,
cached programs:

    plan (DMLPlan, DMLData)
      -> task grid (core/crossfit.TaskGrid, M x K x L per request)
      -> buckets (buckets.plan_buckets: learner x N-bucket x P-bucket)
      -> programs (program.ProgramCache: batched_fit_predict over the
                   CUDA batched_gram / batched_predict kernels)
      -> launches (serverless/backends.py schedules bucket slices)

Every execution backend is a thin scheduler over this layer.
"""
from repro_torch.compile.buckets import (
    BucketKey, Entry, MegabatchPlan, plan_buckets,
)
from repro_torch.compile.program import (
    BucketDispatch, CompileStats, ProgramCache, dispatch_bucket,
    run_bucket, segment_batched_fn,
)

__all__ = [
    "BucketKey", "Entry", "MegabatchPlan", "plan_buckets",
    "BucketDispatch", "CompileStats", "ProgramCache", "dispatch_bucket",
    "run_bucket", "segment_batched_fn",
]
