"""The port's serving tier: :mod:`repro_torch.launch.server` (plan cache,
request coalescing, the open-loop harness), :mod:`repro_torch.launch.serve`
(its command line) and :mod:`repro_torch.launch.resilience` (the
degradation ladder, the circuit breaker, supervised workers).

Importing this package imports none of them, and builds no kernel."""
