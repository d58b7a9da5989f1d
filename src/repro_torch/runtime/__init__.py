"""Host runtime, ported from `repro.runtime`: client faults and elastic
membership (`fault`: `FaultModel`, `ElasticSchedule`, `combined_mask`,
which feed the control trace's mask rows), the synchronization-failure
axis (`desync`: `DesyncModel`, stale round seeds and timing
misalignment) and deterministic fault injection with bounded retry
(`inject`). `sharding` is not ported yet (ROADMAP A11)."""
from repro_torch.runtime.desync import DesyncModel
from repro_torch.runtime.fault import (ElasticSchedule, FaultModel,
                                       combined_mask)
from repro_torch.runtime.inject import (FaultInjector, InjectedFault,
                                        SiteFault, with_retries)

__all__ = [
    "DesyncModel", "ElasticSchedule", "FaultModel", "combined_mask",
    "FaultInjector", "InjectedFault", "SiteFault", "with_retries",
]
