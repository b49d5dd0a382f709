"""Expressions: trees evaluated eagerly as torch ops on device values."""
from .aggregates import (AggregateExpression, Average, Count, CountStar,
                         First, Last, Max, Min, StddevPop, StddevSamp, Sum,
                         VariancePop, VarianceSamp)
from .arithmetic import (Abs, Add, BitwiseAnd, BitwiseNot, BitwiseOr,
                         BitwiseXor, Divide, IntegralDivide, Multiply, Pmod,
                         Remainder, ShiftLeft, ShiftRight, ShiftRightUnsigned,
                         Subtract, UnaryMinus, UnaryPositive)
from .base import (Alias, ColumnRef, DVal, EvalContext, Expression,
                   Literal, StrVal)
from .cast import Cast
from .comparison import (EqualTo, GreaterThan, GreaterThanOrEqual, In,
                         IsNaN, IsNotNull, IsNull, LessThan, LessThanOrEqual,
                         NotEqual)
from .conditional import (AtLeastNNonNulls, CaseWhen, Coalesce, Greatest,
                          If, KnownFloatingPointNormalized, KnownNotNull,
                          Least, NaNvl, NormalizeNaNAndZero, NullIf)
from .datetime_fns import (AddMonths, DateAdd, DateAddInterval, DateDiff,
                           DateFormatClass, DateSub, DayOfMonth, DayOfWeek,
                           DayOfYear, FromUnixTime, FromUtcTimestamp, Hour,
                           LastDay, MicrosToTimestamp, MillisToTimestamp,
                           Minute, Month, MonthsBetween, Quarter, Second,
                           SecondsToTimestamp, TimeAdd, ToUnixTimestamp,
                           ToUtcTimestamp, TruncDate, UnixDate, UnixTimestamp,
                           WeekDay, Year)
from .hash_fns import (Crc32, HiveHash, Md5, Murmur3Hash, Sha1, Sha2,
                       XxHash64)
from .logical import And, Not, Or
from .math_fns import (Acos, Acosh, Asin, Asinh, Atan, Atan2, Atanh, BRound,
                       Cbrt, Ceil, Cos, Cosh, Cot, Exp, Expm1, Floor, Hypot,
                       Log, Log1p, Log2, Log10, Logarithm, Pow, Rint, Round,
                       Signum, Sin, Sinh, Sqrt, Tan, Tanh, ToDegrees,
                       ToRadians)
from .nondeterministic import (InputFileName, MonotonicallyIncreasingID,
                               Rand, SparkPartitionID)
from .string_fns import (Contains, EndsWith, InitCap, Length, Like, Lower,
                         Lpad, Reverse, RLike, Rpad, StartsWith, StringInstr,
                         StringLocate, StringReplace, StringTrim,
                         StringTrimLeft, StringTrimRight, Substring,
                         SubstringIndex, Upper)

__all__ = ["AggregateExpression", "Average", "Count", "CountStar", "Sum",
           "Min", "Max", "First", "Last", "VariancePop", "VarianceSamp",
           "StddevPop", "StddevSamp", "In", "IsNull", "IsNotNull", "IsNaN",
           "Cast", "If", "CaseWhen", "Coalesce", "NullIf", "Greatest",
           "Least", "NaNvl", "AtLeastNNonNulls", "KnownNotNull",
           "KnownFloatingPointNormalized", "NormalizeNaNAndZero",
           "DateAdd", "DateSub", "NotEqual",
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
           "Rpad", "Reverse", "InitCap", "SubstringIndex",
           "Acos", "Acosh", "Asin", "Asinh", "Atan", "Atan2", "Atanh",
           "BRound", "Cbrt", "Ceil", "Cos", "Cosh", "Cot", "Exp", "Expm1",
           "Floor", "Hypot", "Log", "Log1p", "Log2", "Log10", "Logarithm",
           "Pow", "Rint", "Round", "Signum", "Sin", "Sinh", "Sqrt", "Tan",
           "Tanh", "ToDegrees", "ToRadians", "AddMonths", "DateAddInterval",
           "DateDiff", "DateFormatClass", "DayOfMonth", "DayOfWeek",
           "DayOfYear", "FromUnixTime", "FromUtcTimestamp", "Hour",
           "LastDay", "MicrosToTimestamp", "MillisToTimestamp", "Minute",
           "Month", "MonthsBetween", "Quarter", "Second",
           "SecondsToTimestamp", "TimeAdd", "ToUnixTimestamp",
           "ToUtcTimestamp", "TruncDate", "UnixDate", "UnixTimestamp",
           "WeekDay", "Year", "Crc32", "HiveHash", "Md5", "Murmur3Hash",
           "Sha1", "Sha2", "XxHash64", "InputFileName",
           "MonotonicallyIncreasingID", "Rand", "SparkPartitionID"]
