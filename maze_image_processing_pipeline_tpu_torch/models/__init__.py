"""U-Net, GroupNorm and checkpoint reading of the port."""
