from .simulator import (  # noqa: F401
    checker_sinusoid_environment,
    render_camera_views,
    render_equirect_reference,
)
