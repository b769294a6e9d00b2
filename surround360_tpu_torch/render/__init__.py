from .panorama import (  # noqa: F401
    RenderConfig,
    RenderContext,
    build_render_context,
    make_jitted_renderer,
    render_frame,
    state_from_blob,
    state_from_numpy,
    state_to_blob,
    state_to_numpy,
)
