from .novel_view import (  # noqa: F401
    combine_lazy_views,
    combine_novel_views,
    generate_novel_view,
    lazy_warp_columns,
    prepare_pair_flows,
    render_chunk_pair,
    render_lazy_novel_view,
)
