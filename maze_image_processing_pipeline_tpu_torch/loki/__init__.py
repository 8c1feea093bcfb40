"""LOKI re-segmentation on the device (the port's U-Net stage)."""
