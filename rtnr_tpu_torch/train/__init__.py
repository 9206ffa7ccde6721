"""Training: the U-Net step and the scene fine-tune step (``train.trainer``)."""
