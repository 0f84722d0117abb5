"""Serving subsystem (counterpart of ``repro/serve``): frozen register
images, the batched engine, the async service, device meshes.

``servable``  — :class:`ServableModel`, the frozen register image of a
                ConvCoTM, prepared once per model.
``paths``     — the registry of eval paths with bit-identical results.
``engine``    — :class:`ServingEngine`, batched multi-model serving with
                power-of-two buckets, async dispatch handles, hot swap and
                rollback.
``scheduler`` — :class:`MicrobatchScheduler`, the microbatching policy.
``service``   — :class:`ServingService`, the asyncio front end.
``mesh``      — :class:`ServeMesh`, placement across a device mesh,
                replicated or clause-sharded, equal bit for bit to one
                device.
``autotune``  — :class:`TunedPlan` and the per-bucket eval-path autotuner.
``faults``    — fault injection, the circuit breaker's knobs, service
                health and the structured fault errors.
"""

from repro_torch.serve.autotune import AutotuneReport, TunedPlan, autotune_servable
from repro_torch.serve.engine import (
    ClassifyResult,
    InFlightClassify,
    ServeStats,
    ServingEngine,
    classify_raw_step,
    classify_step,
)
from repro_torch.serve.faults import (
    DegradationPolicy,
    DeviceLost,
    FaultError,
    FaultPlan,
    InjectedEngineError,
    PoisonedPayload,
    ServiceExpired,
    ServiceHealth,
    WorkerCrashed,
    chaos_soak,
)
from repro_torch.serve.loadgen import LoadReport, poisson_open_loop
from repro_torch.serve.mesh import (
    Placement,
    ServeMesh,
    classify_step_clause_sharded,
    classify_step_meshed,
    make_serve_mesh,
)
from repro_torch.serve.paths import (
    DENSE,
    PACKED,
    RAW,
    EvalPath,
    available_paths,
    degraded_fallback,
    get_path,
    register_path,
    resolve_path,
    run_path,
    run_path_raw,
)
from repro_torch.serve.scheduler import (
    MicrobatchScheduler,
    PendingRequest,
    QueueFull,
    SchedulerConfig,
)
from repro_torch.serve.servable import (
    ClauseSparsity,
    ServableModel,
    ServableVersion,
    active_pad,
    analyze_sparsity,
    freeze,
    servable_digest,
)
from repro_torch.serve.service import (
    ServiceConfig,
    ServiceOverloaded,
    ServiceResult,
    ServiceStats,
    ServiceStopped,
    ServingService,
)

__all__ = [
    "DENSE",
    "PACKED",
    "RAW",
    "AutotuneReport",
    "ClassifyResult",
    "ClauseSparsity",
    "DegradationPolicy",
    "DeviceLost",
    "EvalPath",
    "FaultError",
    "FaultPlan",
    "InFlightClassify",
    "InjectedEngineError",
    "LoadReport",
    "MicrobatchScheduler",
    "PendingRequest",
    "Placement",
    "PoisonedPayload",
    "QueueFull",
    "SchedulerConfig",
    "ServableModel",
    "ServableVersion",
    "ServeMesh",
    "ServeStats",
    "ServiceConfig",
    "ServiceExpired",
    "ServiceHealth",
    "ServiceOverloaded",
    "ServiceResult",
    "ServiceStats",
    "ServiceStopped",
    "ServingEngine",
    "ServingService",
    "TunedPlan",
    "WorkerCrashed",
    "active_pad",
    "analyze_sparsity",
    "autotune_servable",
    "available_paths",
    "chaos_soak",
    "classify_raw_step",
    "classify_step",
    "classify_step_clause_sharded",
    "classify_step_meshed",
    "degraded_fallback",
    "freeze",
    "get_path",
    "make_serve_mesh",
    "poisson_open_loop",
    "register_path",
    "resolve_path",
    "run_path",
    "run_path_raw",
    "servable_digest",
]
