from .pixflow import (  # noqa: F401
    HINT_DOWN,
    HINT_LEFT,
    HINT_RIGHT,
    HINT_UNKNOWN,
    HINT_UP,
    FlowParams,
    compute_flow,
    make_flow_params,
)
