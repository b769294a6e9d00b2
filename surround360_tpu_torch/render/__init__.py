from .panorama import (  # noqa: F401
    RenderConfig,
    RenderContext,
    build_render_context,
    render_frame,
    state_from_blob,
    state_from_numpy,
    state_to_blob,
    state_to_numpy,
)
