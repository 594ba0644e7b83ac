"""Parameter-search harness (the dev-scripts training family); the port of
``bwd_nlkalman_tpu.train``, with the same public names. Its trials run on
the card unless the caller passes ``device="cpu"``."""

from .search import (  # noqa: F401
    TrialResult,
    evaluate,
    random_search,
    coordinate_descent,
    format_table_row,
    line_search,
    gradient_descent,
    grid_search_2d,
)
from .fixtures import (  # noqa: F401
    Fixtures,
    make_fixtures,
    cached_fixtures,
)
from .view_results import (  # noqa: F401
    load_table,
    best_rows,
    ascii_landscape,
)
