"""Generate exec: explode / posexplode / stack (port of
``spark_rapids_tpu/exec/generate.py``), all on the device.

Per input batch: the generator's counts (a list's lengths, or one row for
``outer``'s NULL and empty lists, or a sequence's counts), the output
size read to the host once, the repeat index ``rep`` (output row -> input
row) by ``torch.repeat_interleave`` and each output row's place ``pos``
within its input row; the generated columns come from the generator
(a list flattened by its slots, a map's keys and values by the same
slots), the pass-through columns (lists, maps and structs among them)
through ``gather_batch``. The output can far outgrow its input, so each batch
runs under the split-and-retry ladder (mem/retry.py), as the
reference's does: on a SplitAndRetryOOM the input halves and the halves
run again.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from ..columnar import ColumnarBatch, DeviceColumn
from ..columnar.nested import null_rows
from ..exprs.base import EvalContext
from ..exprs.compiler import batch_device, batch_dvals, gather_batch
from ..exprs.generators import Generator
from ..mem.retry import with_retry
from ..mem.spillable import SpillableBatch
from ..types import Schema, StructField, torch_dtype
from .base import ExecContext, TpuExec

__all__ = ["TpuGenerateExec"]


def _value_bytes(dt) -> int:
    """Device bytes of one generated value and its validity."""
    from ..columnar.strrect import RECT_MAX_BYTES
    from ..types import STRING, StructType
    if dt == STRING:
        return RECT_MAX_BYTES.default + 5
    if isinstance(dt, StructType):
        return 1 + sum(_value_bytes(f.dtype) for f in dt.fields)
    return dt.np_dtype.itemsize + 1


class TpuGenerateExec(TpuExec):
    def __init__(self, generator: Generator, required_cols: List[str],
                 child: TpuExec, output_names: Optional[List[str]] = None):
        super().__init__([child])
        self.generator = generator
        self.required_cols = list(required_cols)
        child_schema = child.output_schema()
        gen_fields = generator.generator_output(child_schema)
        if output_names:
            gen_fields = [StructField(n, f.dtype, f.nullable)
                          for n, f in zip(output_names, gen_fields)]
        self._gen_fields = gen_fields
        self._use_kernel = False
        self._schema = Schema([child_schema[c] for c in self.required_cols]
                              + gen_fields)

    def output_schema(self) -> Schema:
        return self._schema

    def _row_bytes(self, sub: ColumnarBatch) -> int:
        """Device bytes of one output row: the pass-through columns' a row
        and the generated columns' values and validity (a string's at the
        byte rectangle's widest, a struct's its fields')."""
        return sum(c.nbytes() // max(c.padded_len, 1) for c in sub.columns
                   if isinstance(c, DeviceColumn)) + sum(
            _value_bytes(f.dtype) for f in self._gen_fields)

    def _generate(self, ctx: ExecContext,
                  sb: SpillableBatch) -> ColumnarBatch:
        batch = sb.get()
        with ctx.semaphore.held():
            device = batch_device(batch)
            ectx = EvalContext(batch.schema, batch_dvals(batch),
                               batch.num_rows, batch.padded_len, device,
                               partition_id=batch.partition_id,
                               use_kernel=self._use_kernel)
            counts, n_bad, state = self.generator.counts(ectx)
            # the one host read of a batch: the output's size (and whether
            # a sequence's step cannot reach its stop)
            total, bad = (int(x) for x in torch.stack(
                [counts.sum(), n_bad]).tolist())
            if bad:
                raise self.generator.error()
            rows = torch.arange(counts.shape[0], device=device)
            rep = torch.repeat_interleave(rows, counts, output_size=total)
            start = torch.cumsum(counts, 0) - counts
            pos = torch.arange(total, device=device) - start[rep]
            sub = ColumnarBatch(
                [batch.column_by_name(c) for c in self.required_cols],
                batch.num_rows,
                Schema([batch.schema[c] for c in self.required_cols]))
            # the output's bytes are reserved before it is built: one that
            # cannot fit raises SplitAndRetryOOM, and the ladder halves
            # the input
            need = total * self._row_bytes(sub)
            ctx.memory.reserve_absorbing_retries(need)
            try:
                out = list(gather_batch(sub, rep).columns)
                for v, f in zip(self.generator.outputs(state, rep, pos),
                                self._gen_fields):
                    if isinstance(v.data, DeviceColumn):
                        out.append(null_rows(v.data, v.validity))
                        continue
                    data = v.data.to(torch_dtype(f.dtype))
                    out.append(DeviceColumn(torch.where(
                        v.validity, data, torch.zeros_like(data)),
                        v.validity, f.dtype))
            finally:
                ctx.memory.release(need)
        sb.close()
        return ColumnarBatch(out, total, self._schema, batch.partition_id)

    def do_execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from ..exprs.rect_match import PALLAS_ENABLED
        self._use_kernel = bool(ctx.conf.get(PALLAS_ENABLED))
        for batch in self.children[0].execute(ctx):
            sb = SpillableBatch(batch, ctx.memory)
            yield from with_retry([sb], lambda b: self._generate(ctx, b),
                                  ctx=ctx, op="Generate")

    def describe(self):
        return (f"Generate[{self.generator.key()}, "
                f"required={self.required_cols}]")
