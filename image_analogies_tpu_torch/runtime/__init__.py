"""Supervised execution of the port.

`runtime/faults.py`: deterministic fault injection at the runners'
level, kernel, checkpoint and transfer points, armed by `IA_FAULT_PLAN`.

`runtime/supervisor.py`: per-level watchdog deadlines from the cost
model, retry with resume from the per-level checkpoints, a degradation
ladder over the process-wide switches, and a flight dump when it gives
up.  The CLI's `synth|batch|video --supervise`.
"""

from .faults import (  # noqa: F401
    FaultPlan,
    InjectedFault,
    LevelAborted,
    fire,
    resolve_fault_plan,
    set_fault_plan,
)
from .supervisor import (  # noqa: F401
    Rung,
    SupervisorGaveUp,
    default_ladder,
    supervise,
)

__all__ = [
    "FaultPlan",
    "InjectedFault",
    "LevelAborted",
    "Rung",
    "SupervisorGaveUp",
    "default_ladder",
    "fire",
    "resolve_fault_plan",
    "set_fault_plan",
    "supervise",
]
