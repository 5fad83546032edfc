from .linear import MapFilterProject  # noqa: F401
from .scalar import (  # noqa: F401
    CallBinary,
    CallUnary,
    CallVariadic,
    Column,
    DictFunc,
    EvalErr,
    Literal,
)
