"""U-Net, polytaxo classifier, GroupNorm, checkpoints and the inference nodes of the port."""
