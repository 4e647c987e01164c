from .artifacts import (log_pretty_table, make_logdir, minmax_normalize,
                        save_output)

__all__ = ["save_output", "make_logdir", "log_pretty_table",
           "minmax_normalize"]
