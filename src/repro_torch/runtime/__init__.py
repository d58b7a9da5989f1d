"""Host runtime, ported from `repro.runtime`: client faults and elastic
membership (`fault`: `FaultModel`, `ElasticSchedule`, `combined_mask`,
which feed the control trace's mask rows) and deterministic fault
injection with bounded retry (`inject`). `desync` and `sharding` are not
ported yet (ROADMAP A9, A11)."""
from repro_torch.runtime.fault import (ElasticSchedule, FaultModel,
                                       combined_mask)
from repro_torch.runtime.inject import (FaultInjector, InjectedFault,
                                        SiteFault, with_retries)

__all__ = [
    "ElasticSchedule", "FaultModel", "combined_mask",
    "FaultInjector", "InjectedFault", "SiteFault", "with_retries",
]
