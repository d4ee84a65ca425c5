from .ckpt import (keyed_leaves, latest_step, load_policy,
                   restore_checkpoint, save_checkpoint, save_policy)
