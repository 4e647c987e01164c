from .checkpoint import (load_checkpoint, restore_into, resume_state,
                         save_checkpoint)

__all__ = ["load_checkpoint", "save_checkpoint", "restore_into",
           "resume_state"]
