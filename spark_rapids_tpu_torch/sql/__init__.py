"""SQL front end (port of ``spark_rapids_tpu/sql/``): text -> DataFrame
plan over the session's temp views.

``parser.py`` is the reference's parser unchanged (it imports only the
standard library). ``lowering.py`` lowers its AST onto the port's
DataFrame API: SELECT / DISTINCT / FROM / JOIN (inner, left/right/full
outer, semi, anti, cross; ON and USING) / WHERE / GROUP BY (names,
aliases, ordinals) / HAVING / ORDER BY / LIMIT / UNION [ALL] / INTERSECT
/ EXCEPT / WITH (CTEs) / subqueries in FROM / CASE WHEN / CAST / BETWEEN
/ IN / LIKE / IS [NOT] NULL / date literals and intervals / aggregate
functions incl. DISTINCT forms. What the port does not have yet raises,
naming its slice (lowering.py).
"""
from .lowering import lower_statement
from .parser import SqlError, parse

__all__ = ["parse", "lower_statement", "SqlError"]
