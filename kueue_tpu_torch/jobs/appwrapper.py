"""AppWrapper integration (reference pkg/controller/jobs/appwrapper, 361
LoC): a wrapper bundling arbitrary component pod sets into one gang."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..jobframework.interface import IntegrationCallbacks, register_integration
from .base import PodTemplate, TemplateJob


@dataclass
class Component:
    name: str
    count: int = 1
    requests: dict[str, int] = field(default_factory=dict)


class AppWrapper(TemplateJob):
    kind = "AppWrapper"
    STATUS_FIELDS = ("phase",)

    def __init__(self, name: str, components: list[Component], **kw):
        templates = [PodTemplate(name=c.name, count=c.count,
                                 requests=dict(c.requests))
                     for c in components]
        super().__init__(name, templates=templates, **kw)
        self.phase: Optional[str] = None     # Succeeded | Failed

    def mark_phase(self, phase: str) -> None:
        self.phase = phase

    def finished(self) -> tuple[str, bool, bool]:
        if self.phase == "Succeeded":
            return "AppWrapper succeeded", True, True
        if self.phase == "Failed":
            return "AppWrapper failed", False, True
        return "", False, False


register_integration(IntegrationCallbacks(
    name="workload.codeflare.dev/appwrapper", gvk=AppWrapper.kind,
    new_job=AppWrapper))
