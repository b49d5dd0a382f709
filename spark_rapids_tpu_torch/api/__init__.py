"""Public API: the session, DataFrame and functions."""
from . import functions
from .dataframe import DataFrame, GroupedData, TorchSession

__all__ = ["TorchSession", "DataFrame", "GroupedData", "functions"]
