from .linear import MapFilterProject  # noqa: F401
from .scalar import CallBinary, Column, EvalErr, Literal  # noqa: F401
