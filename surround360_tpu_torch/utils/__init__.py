from . import math_util  # noqa: F401
