"""repro_torch.serve -- logdet-as-a-service on top of `LogdetPlan`.

Counterpart of `repro.serve`.  Layers (each usable on its own):

==============  ========================================================
``aot``         plan export/import: `export_plan` / `load_plan` write
                and read a plan's resolved form (spec, explicit config,
                diagnostics) with a device-fingerprint header naming the
                kernel build -- the serving process runs no selector and
                no autotune, and builds no kernel, at request time
``bucket``      the pad-to-bucket policy (`BucketLadder`,
                `pad_to_bucket`, `stack_to_bucket`) and the warm-plan
                LRU (`PlanCache`)
``batching``    request admission and coalescing of heterogeneous
                ``(A, method, rtol)`` traffic into homogeneous stacks
``service``     `LogdetService` -- submit() -> Future[LogdetResult],
                one continuous-batching drain thread, on the card
                unless ``ServeConfig(device="cpu")``
``http``        stdlib JSON front end (``POST /v1/logdet`` ...)
==============  ========================================================

``python -m repro_torch.serve`` runs the HTTP service.
"""
from repro_torch.serve.aot import (
    PLAN_FORMAT, PlanExportError, PlanFingerprintError, device_fingerprint,
    export_plan, load_plan, read_header,
)
from repro_torch.serve.batching import BatchGroup, Request, coalesce
from repro_torch.serve.bucket import (
    DEFAULT_BUCKETS, BucketLadder, PlanCache, bucket_batch, pad_to_bucket,
    stack_to_bucket,
)
from repro_torch.serve.service import (
    LogdetService, ServeConfig, ServiceClosed, plan_filename,
)

__all__ = [
    "PLAN_FORMAT", "PlanExportError", "PlanFingerprintError",
    "device_fingerprint", "export_plan", "load_plan", "read_header",
    "BatchGroup", "Request", "coalesce",
    "DEFAULT_BUCKETS", "BucketLadder", "PlanCache", "bucket_batch",
    "pad_to_bucket", "stack_to_bucket",
    "LogdetService", "ServeConfig", "ServiceClosed", "plan_filename",
]
