from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig, RoutingOracle, ServingEngine, StepEngine, TorchModelServer)
from repro_torch.serving.guard import (  # noqa: F401
    RecompileError, recompile_guard)
from repro_torch.serving.scheduler import (  # noqa: F401
    ContinuousScheduler, Scheduler, SchedulerConfig, StaticBatchScheduler,
    make_scheduler)
from repro_torch.serving.spec import (  # noqa: F401
    PredictorSpec, ServeSpec, TenantSpec, load_tenants)
from repro_torch.serving.workload import (  # noqa: F401
    poisson_arrivals)
