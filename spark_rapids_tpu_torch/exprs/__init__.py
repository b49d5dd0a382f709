"""Expressions: trees evaluated eagerly as torch ops on device values."""
from .aggregates import (AggregateExpression, Average, Count, CountStar,
                         First, Last, Max, Min, Sum)
from .arithmetic import (Abs, Add, BitwiseAnd, BitwiseNot, BitwiseOr,
                         BitwiseXor, Divide, IntegralDivide, Multiply, Pmod,
                         Remainder, ShiftLeft, ShiftRight, ShiftRightUnsigned,
                         Subtract, UnaryMinus, UnaryPositive)
from .base import (Alias, ColumnRef, DVal, EvalContext, Expression,
                   Literal, StrVal)
from .cast import Cast
from .comparison import (EqualTo, GreaterThan, GreaterThanOrEqual, In,
                         IsNotNull, IsNull, LessThan, LessThanOrEqual,
                         NotEqual)
from .conditional import CaseWhen, Coalesce, Greatest, If, Least, NullIf
from .datetime_fns import DateAdd, DateSub
from .logical import And, Not, Or
from .string_fns import (Contains, EndsWith, InitCap, Length, Like, Lower,
                         Lpad, Reverse, RLike, Rpad, StartsWith, StringInstr,
                         StringLocate, StringReplace, StringTrim,
                         StringTrimLeft, StringTrimRight, Substring,
                         SubstringIndex, Upper)

__all__ = ["AggregateExpression", "Average", "Count", "CountStar", "Sum",
           "Min", "Max", "First", "Last", "In", "IsNull", "IsNotNull",
           "Cast", "If", "CaseWhen", "Coalesce", "NullIf", "Greatest",
           "Least", "DateAdd", "DateSub", "NotEqual",
           "Add", "Multiply", "Subtract", "Divide", "IntegralDivide",
           "Remainder", "Pmod", "UnaryMinus", "UnaryPositive", "Abs",
           "BitwiseAnd", "BitwiseOr", "BitwiseXor", "BitwiseNot",
           "ShiftLeft", "ShiftRight", "ShiftRightUnsigned", "Alias",
           "ColumnRef", "DVal", "EvalContext", "Expression", "Literal",
           "StrVal", "EqualTo", "GreaterThan", "GreaterThanOrEqual",
           "LessThan", "LessThanOrEqual", "And", "Or", "Not", "Contains",
           "EndsWith", "Like", "RLike", "StartsWith", "StringInstr", "StringLocate",
           "Length", "Upper", "Lower", "Substring", "StringTrim",
           "StringTrimLeft", "StringTrimRight", "StringReplace", "Lpad",
           "Rpad", "Reverse", "InitCap", "SubstringIndex"]
