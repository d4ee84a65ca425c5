from .ckpt import latest_step, load_policy, save_policy
