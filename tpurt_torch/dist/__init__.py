"""Multi-device frames on ``torch.distributed`` (one process per rank):
the band-sharded frame (port of ``tpurt/dist/sharding.py``) and the
sharded-geometry frame (port of ``tpurt/dist/geometry.py``)."""
from .geometry import (freeze_meta, hbm_accounting, rank_tensors,  # noqa: F401
                       render_frame_sharded_geometry, ring_gather,
                       shard_geometry, shard_tables)
from .sharding import (gather_frame, make_mesh, render_frame_sharded,  # noqa: F401
                       ring_shift)
