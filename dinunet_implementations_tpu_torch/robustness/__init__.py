from .attacks import AttackPlan, attack_window, make_attack_fn, parse_attack_plan
from .faults import FaultPlan, fault_window, parse_fault_plan, poison_inputs
from .health import REPUTATION_KEYS, default_health, health_summary, reputation_fields
from .membership import (
    MembershipError,
    MembershipTable,
    membership_rollup,
    move_slot_state,
    reset_slot_state,
)
from .preemption import Preempted, PreemptionGuard
from .retry import RetryTimeout, with_retry

__all__ = ["AttackPlan", "FaultPlan", "MembershipError", "MembershipTable", "Preempted",
           "PreemptionGuard", "REPUTATION_KEYS", "RetryTimeout", "attack_window",
           "default_health", "fault_window", "health_summary", "make_attack_fn",
           "membership_rollup", "move_slot_state", "parse_attack_plan", "parse_fault_plan",
           "poison_inputs", "reputation_fields", "reset_slot_state", "with_retry"]
