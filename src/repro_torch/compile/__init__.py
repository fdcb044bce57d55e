"""The megabatch task compiler.

Lowers the union of all pending WorkRequests into a small set of bucketed,
cached programs:

    plan (DMLPlan, DMLData)
      -> task grid (core/crossfit.TaskGrid, M x K x L per request)
      -> buckets (buckets.plan_buckets: learner x N-bucket x P-bucket)
      -> programs (program.ProgramCache: batched_fit_predict over the
                   CUDA batched_gram / batched_predict kernels; same-shape
                   blocks fused, tail blocks coalesced)
      -> pages (pages.PagePool: feature pages resident on the device)
      -> launches (serverless/backends.py schedules bucket slices)

Every execution backend is a thin scheduler over this layer.
"""
from repro_torch.compile.buckets import (
    BucketKey, Entry, MegabatchPlan, pack_tail_blocks, plan_buckets,
)
from repro_torch.compile.pages import PageDirectory, PagePool, PageStats
from repro_torch.compile.program import (
    BucketDispatch, CompileStats, ProgramCache, dispatch_bucket,
    segment_batched_fn,
)

__all__ = [
    "BucketKey", "Entry", "MegabatchPlan", "pack_tail_blocks",
    "plan_buckets", "PageDirectory", "PagePool", "PageStats",
    "BucketDispatch", "CompileStats", "ProgramCache", "dispatch_bucket",
    "segment_batched_fn",
]
