from .novel_view import (  # noqa: F401
    combine_lazy_views,
    lazy_warp_columns,
    prepare_pair_flows,
    render_chunk_pair,
    render_lazy_novel_view,
)
