from .expr import (  # noqa: F401
    Cast, Expr, FunctionCall, InputRef, Literal, call, cast, col, register,
    uses_host_callback,
)
from .agg import AggCall, agg, count_star  # noqa: F401
