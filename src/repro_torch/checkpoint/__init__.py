from .store import (  # noqa: F401
    AsyncCheckpointer, host_tree, latest_step, reshard_reservoir, restore_checkpoint,
    save_checkpoint,
)
