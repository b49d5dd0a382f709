"""Hash-aggregate exec, keyless path (port of
``spark_rapids_tpu/exec/aggregate.py``).

Per batch the fused pre-stages (filters and projections folded in by the
planner, as the reference's ``_fold_stages`` does) run over the batch
with a running keep-mask, then every aggregate's update reduces the kept
rows to one partial. The partials of all batches merge in one more
reduction, and finalize yields the one-row result.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar import ColumnarBatch, DeviceColumn
from ..exprs.aggregates import AggregateExpression
from ..exprs.base import DVal, EvalContext
from ..exprs.compiler import batch_device, batch_dvals
from ..types import Schema, StructField, torch_dtype
from .base import ExecContext, TpuExec
from .groupby_core import global_groupby

__all__ = ["TpuHashAggregateExec"]


def _apply_pre_stages(stages, in_schema: Schema, base_dvals, num_rows: int,
                      padded_len: int, device):
    """Run the fused ("filter", cond) / ("project", exprs, schema)
    pre-stages; returns (EvalContext over the last stage's schema, keep
    mask)."""
    ctx = EvalContext(in_schema, base_dvals, num_rows, padded_len, device)
    keep = ctx.row_mask()
    for st in stages:
        if st[0] == "filter":
            pv = st[1].eval_device(ctx)
            keep = torch.logical_and(keep,
                                     torch.logical_and(pv.data, pv.validity))
        else:
            _, exprs, out_schema = st
            ctx = EvalContext(out_schema, [e.eval_device(ctx) for e in exprs],
                              num_rows, padded_len, device)
    return ctx, keep


class TpuHashAggregateExec(TpuExec):
    """Keyless device aggregate with fused pre-stages."""

    def __init__(self, groupings: Sequence, aggs:
                 Sequence[AggregateExpression], child: TpuExec,
                 pre_stages: Optional[list] = None,
                 eval_schema: Optional[Schema] = None):
        super().__init__([child])
        if groupings:
            raise NotImplementedError(
                "keyed aggregation arrives with the q1 slice")
        self.groupings: list = []
        self.aggs = list(aggs)
        self.pre_stages = pre_stages or []
        self._eval_schema = eval_schema if eval_schema is not None \
            else child.output_schema()
        cs = self._eval_schema
        self._schema = Schema([StructField(a.name_hint, a.data_type(cs), True)
                               for a in self.aggs])
        self._partial_types = [a.partial_types(cs) for a in self.aggs]

    def output_schema(self) -> Schema:
        return self._schema

    def _update(self, batch: ColumnarBatch):
        device = batch_device(batch)
        base = batch_dvals(batch)
        in_schema = self.children[0].output_schema()
        ctx, keep = _apply_pre_stages(self.pre_stages, in_schema, base,
                                      batch.num_rows, batch.padded_len,
                                      device)
        vals = [[e.eval_device(ctx) for e in a.input_exprs()]
                for a in self.aggs]
        return global_groupby(vals, self.aggs, "update", keep)

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        partials: List[list] = [self._update(b)
                                for b in self.children[0].execute(ctx)]
        # merge: partial column k of every batch side by side
        cols = []
        k = 0
        for types in self._partial_types:
            for pt in types:
                if partials:
                    d = torch.cat([p[k][0] for p in partials])
                    v = torch.cat([p[k][1] for p in partials])
                else:
                    d = torch.zeros(0, dtype=torch_dtype(pt),
                                    device=ctx.device)
                    v = torch.zeros(0, dtype=torch.bool, device=ctx.device)
                cols.append(DVal(d, v, pt))
                k += 1
        live = torch.ones(len(partials), dtype=torch.bool, device=ctx.device)
        vals, pos = [], 0
        for types in self._partial_types:
            vals.append(cols[pos:pos + len(types)])
            pos += len(types)
        merged = global_groupby(vals, self.aggs, "merge", live)
        out_cols, pos = [], 0
        for a, types, f in zip(self.aggs, self._partial_types,
                               self._schema.fields):
            parts = [DVal(d, v, t) for (d, v), t
                     in zip(merged[pos:pos + len(types)], types)]
            pos += len(types)
            final = a.finalize(parts)
            out_cols.append(DeviceColumn(final.data, final.validity,
                                         f.dtype))
        yield ColumnarBatch(out_cols, 1, self._schema)

    def describe(self):
        a = ", ".join(x.name_hint for x in self.aggs)
        fused = ""
        if self.pre_stages:
            parts = [("filter" if s[0] == "filter" else "project")
                     for s in self.pre_stages]
            fused = f" fused=[{'+'.join(parts)}]"
        return f"HashAggregate[keys=[], aggs=[{a}]]{fused}"
