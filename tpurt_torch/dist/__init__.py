"""The band-sharded frame on ``torch.distributed`` (one process per rank):
port of ``tpurt/dist/sharding.py``."""
from .sharding import make_mesh, render_frame_sharded  # noqa: F401
