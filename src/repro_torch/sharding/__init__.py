"""In-mesh executors of the planner's data and feature axes (gram.py) and
the topology backend's bucket -> host placement policy (policy.py)."""
