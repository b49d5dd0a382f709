"""Expressions: trees evaluated eagerly as torch ops on device values."""
from .aggregates import AggregateExpression, Average, Count, CountStar, Sum
from .arithmetic import Add, Multiply, Subtract
from .base import (Alias, ColumnRef, DVal, EvalContext, Expression,
                   Literal, StrVal)
from .comparison import (EqualTo, GreaterThan, GreaterThanOrEqual, LessThan,
                         LessThanOrEqual)
from .logical import And, Not, Or
from .string_fns import (Contains, EndsWith, Like, RLike, StartsWith,
                         StringInstr, StringLocate)

__all__ = ["AggregateExpression", "Average", "Count", "CountStar", "Sum",
           "Add", "Multiply", "Subtract", "Alias",
           "ColumnRef", "DVal", "EvalContext", "Expression", "Literal",
           "StrVal", "EqualTo", "GreaterThan", "GreaterThanOrEqual",
           "LessThan", "LessThanOrEqual", "And", "Or", "Not", "Contains",
           "EndsWith", "Like", "RLike", "StartsWith", "StringInstr", "StringLocate"]
