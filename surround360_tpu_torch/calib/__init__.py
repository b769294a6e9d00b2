from .geometric import (  # noqa: F401
    CalibrationObservations,
    GeometricCalibrationConfig,
    calibrate_geometric,
    generate_artificial_points,
    perturb_rig,
    reprojection_report,
)
