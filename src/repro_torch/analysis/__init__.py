"""Static and runtime auditing of the port's serving core (own copy of
``repro.analysis``, retargeted at PyTorch).

The serving core's throughput rests on invariants it upholds only by
convention — one host sync a decode tick and none in the offloader's
swap window, kernel libraries loaded once, ``(seed, request_id,
token_idx)`` seed discipline, monotonic per-link virtual clocks with
conserved wire-byte books.  This package machine-checks them:

:mod:`repro_torch.analysis.lint`
    AST passes over the port (host-sync, offload-sync, obs-hot-path,
    retrace-jit as kernel builds / compiles / captures in the hot path,
    prng-fold-drop as ``Generator.manual_seed`` hygiene) with a
    ``# repro-torch-audit: allow(<rule>) — <reason>`` suppression syntax.
    Runnable as ``python -m repro_torch.analysis [paths]
    [--strict-suppressions]``.

:mod:`repro_torch.analysis.invariants`
    The runtime :class:`EngineAuditor`, enabled via
    ``EngineConfig(strict=True)`` or ``REPRO_STRICT=1`` (tests default it
    on): page-table refcount/leak audits, the ``Status`` lifecycle FSM,
    transport books monotone across every crossing and reshard, offload
    double-buffer parity, and kernel libraries never built or loaded
    again mid-serve.
"""

from repro_torch.analysis.invariants import (EngineAuditor,
                                             InvariantViolation,
                                             library_identity)
from repro_torch.analysis.lint import AuditConfig, Violation, run_lint

__all__ = [
    "AuditConfig", "EngineAuditor", "InvariantViolation", "Violation",
    "library_identity", "run_lint",
]
