"""Distributed serving support: the straggler monitor the bucket executor's
deadline budgeting reads."""
from .fault_tolerance import StragglerMonitor                     # noqa: F401
