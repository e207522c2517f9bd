from .build import get_lib, native_build_sah  # noqa: F401
