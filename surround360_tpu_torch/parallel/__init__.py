from .mesh import make_render_mesh, shard_frame_batch, sharded_render_step  # noqa: F401
