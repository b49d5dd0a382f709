"""Planning: logical plan, tagging metas, conversion to execs."""
