from .sample import (uniform, quniform, loguniform, qloguniform, randint,
                     qrandint, lograndint, choice, sample_from, grid_search,
                     Domain, GridSearch)
from .searcher import (Searcher, BasicVariantGenerator, RandomSearch,
                       ConcurrencyLimiter)
from .variant_generator import generate_variants, count_grid_variants

__all__ = [
    "uniform", "quniform", "loguniform", "qloguniform", "randint",
    "qrandint", "lograndint", "choice", "sample_from", "grid_search",
    "Domain", "GridSearch", "Searcher", "BasicVariantGenerator",
    "RandomSearch", "ConcurrencyLimiter", "generate_variants",
    "count_grid_variants",
]
