from .camera import (  # noqa: F401
    FTHETA,
    RECTILINEAR,
    Camera,
    approximate_usable_pixels_radius,
    camera_from_json,
    camera_to_json,
    create_rescaled_camera,
    get_fov,
    is_behind,
    is_outside_fov,
    make_camera,
    pixel_to_camera,
    pixel_to_rig_direction,
    pixel_to_rig_near_infinity,
    sees,
    world_to_pixel,
)
from .rig import Rig, load_rig, make_ring_rig, save_rig  # noqa: F401
