from repro_torch.checkpoint.ckpt import save_checkpoint, restore_checkpoint, latest_step  # noqa: F401
