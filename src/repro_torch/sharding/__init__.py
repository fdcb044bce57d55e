"""The mesh collectives and the task-axis split (collectives.py), the
in-mesh executors of the planner's data and feature axes (gram.py), and
the megabatch split and the topology backend's bucket -> host placement
policy (policy.py)."""
