from .builder import build_bvh_sah  # noqa: F401
from .flat import FlatBVH  # noqa: F401
from .wide import LEAF8_MAX, collapse8  # noqa: F401
