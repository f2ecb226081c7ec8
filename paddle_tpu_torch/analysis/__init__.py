"""paddle_tpu_torch.analysis — the `Finding` record of the obs audits.

The reference's static-analysis passes (jaxpr audit, AST lint, serving
and SPMD audits) run over XLA programs; their port over torch.fx graphs
is ROADMAP's "Static analysis" entry. What exists here is the record
they and the obs audits share.
"""
from .findings import SEVERITIES, Finding

__all__ = ["Finding", "SEVERITIES"]
