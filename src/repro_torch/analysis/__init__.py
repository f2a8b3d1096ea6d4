"""Static analysis of the port's plans: the plan and record-store verifier
(:mod:`repro_torch.analysis.verify`). The reference's ``hlo`` module, an
XLA-HLO analysis, has no counterpart here."""
from .verify import (  # noqa: F401
    PlanVerificationError, VerifyReport, Violation, plan_rule_names,
    verify_plan, verify_records)
