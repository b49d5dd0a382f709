"""Plan-meta tagging tree (port of ``spark_rapids_tpu/plan/meta.py``).

Each logical node is wrapped in a meta that records why it cannot run on
the device, then converts to a physical exec. The port has no host
engine yet, so converting a node that carries a reason raises
NotImplementedError with it.
"""
from __future__ import annotations

from typing import List

from ..config import TpuConf
from ..exec.base import TpuExec

__all__ = ["PlanMeta"]


class PlanMeta:
    def __init__(self, plan, conf: TpuConf):
        self.plan = plan
        self.conf = conf
        self.reasons: List[str] = []
        self.child_metas: List[PlanMeta] = []

    def will_not_work_on_tpu(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_run_on_tpu(self) -> bool:
        return not self.reasons

    def tag(self) -> None:
        if not self.conf.sql_enabled:
            self.will_not_work_on_tpu("spark.rapids.tpu.sql.enabled is false")
        else:
            self.tag_self()
        for c in self.child_metas:
            c.tag()

    def tag_self(self) -> None:
        """Node-specific checks; override."""

    def convert(self) -> TpuExec:
        children = [c.convert() for c in self.child_metas]
        if not self.can_run_on_tpu:
            raise NotImplementedError(
                f"{type(self.plan).__name__} cannot run on the device: "
                + "; ".join(self.reasons)
                + " (the port has no host engine; see ROADMAP.md Queue A)")
        return self.convert_to_tpu(children)

    def convert_to_tpu(self, children) -> TpuExec:
        raise NotImplementedError
