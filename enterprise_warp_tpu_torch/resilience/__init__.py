"""Resilience: the ingestion audit and kernel-health ladder
(``integrity``), deterministic fault injection (``faults``) and the
supervised dispatch with its demotion ladder and graceful preemption
(``supervisor``)."""

from .faults import (FaultPlan, FaultSpec, InjectedFault, fire,
                     install_plan, plan)
from .integrity import (EXIT_QUARANTINED, DataQualityReport,
                        DataQuarantine, HealthLedger, PulsarQuarantine,
                        audit_tim)
from .supervisor import (EXIT_DEMOTED, BlockSupervisor, DispatchHang,
                         PlatformDemotion, apply_demotion, current_level,
                         install_graceful_sigterm, next_level,
                         preemption_requested, request_preemption)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "fire", "install_plan",
    "plan", "DataQualityReport", "DataQuarantine", "PulsarQuarantine",
    "HealthLedger", "audit_tim", "EXIT_QUARANTINED", "EXIT_DEMOTED",
    "BlockSupervisor", "DispatchHang", "PlatformDemotion",
    "apply_demotion", "current_level", "next_level",
    "install_graceful_sigterm", "preemption_requested",
    "request_preemption",
]
