from .artifacts import (log_pretty_table, make_logdir, minmax_normalize,
                        save_output)
from .grid import make_grid
from .seeding import fold_in, key_iter, set_global_seed

__all__ = ["save_output", "make_logdir", "log_pretty_table",
           "minmax_normalize", "set_global_seed", "key_iter", "fold_in",
           "make_grid"]
