"""JSON functions (the classes of ``spark_rapids_tpu/exprs/json_fns.py``):
``get_json_object``, ``from_json``, ``to_json`` and ``json_tuple``. The
reference runs them on its host engine over Arrow; the port has no host
engine and refuses them at planning (``NESTED_REST``)."""
from __future__ import annotations

from ..types import NESTED_REST, STRING, StructField, StructType
from .base import Expression, Literal

__all__ = ["GetJsonObject", "JsonToStructs", "StructsToJson", "JsonTuple"]


class _Refused(Expression):
    def device_unsupported_reason(self, schema):
        return f"{type(self).__name__} arrives with {NESTED_REST}"

    def data_type(self, schema):
        return STRING


class GetJsonObject(_Refused):
    def __init__(self, child, path):
        self.children = [child, path]


class JsonToStructs(_Refused):
    def __init__(self, child, schema):
        self.children = [child]
        self.target = schema

    def data_type(self, schema):
        return self.target


class StructsToJson(_Refused):
    def __init__(self, child):
        self.children = [child]


class JsonTuple(_Refused):
    def __init__(self, child, *fields):
        self.children = [child]
        self.fields = [f.value if isinstance(f, Literal) else str(f)
                       for f in fields]

    def data_type(self, schema):
        return StructType([StructField(f"c{i}", STRING)
                           for i in range(len(self.fields))])
