from . import plan
from .plan import BuildDesc, DataflowDescription
from .runtime import Dataflow, render_dataflow

__all__ = ["plan", "BuildDesc", "DataflowDescription", "Dataflow", "render_dataflow"]
