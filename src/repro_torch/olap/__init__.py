"""OLAP layer: tables, the logical plan IR, its verifier and optimizer,
the LLM operators, the physical planner and the ``Query`` session."""
