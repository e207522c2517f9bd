from .scene import FlatScene, flatten_scene  # noqa: F401
