"""Always-on semantic query service over the port's serving spine.

A stdlib-only HTTP front-end (:mod:`repro_torch.service.server`) over a
single pump thread (:mod:`repro_torch.service.core`) that drives the
fair-share ``Scheduler`` tick loop, per-tenant SLO admission control
with 429-style shedding (:mod:`repro_torch.service.slo`), a retrying
client (:mod:`repro_torch.service.client`), and warm restart of the
session's instance-optimization state
(:mod:`repro_torch.service.checkpoint`), in the reference's format.
"""
from repro_torch.service.checkpoint import restore_warm_state, save_warm_state
from repro_torch.service.client import ServiceClient
from repro_torch.service.core import SemanticQueryService
from repro_torch.service.server import serve
from repro_torch.service.slo import AdmissionController, TenantSLO

__all__ = [
    "AdmissionController",
    "SemanticQueryService",
    "ServiceClient",
    "TenantSLO",
    "restore_warm_state",
    "save_warm_state",
    "serve",
]
