from . import plan
from .plan import BuildDesc, DataflowDescription

__all__ = ["plan", "BuildDesc", "DataflowDescription"]
