"""Make ``repro_torch`` importable when the package is not installed.

With ``pip install -e .`` (see pyproject.toml) this module is a no-op;
from a bare source checkout it falls back to the in-tree ``src/`` layout,
independent of the current working directory.
"""
import os
import sys

try:
    import repro_torch  # noqa: F401
except ModuleNotFoundError:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    os.pardir, "src"))
