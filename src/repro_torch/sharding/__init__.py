"""In-mesh executors of the planner's data and feature axes (gram.py)."""
