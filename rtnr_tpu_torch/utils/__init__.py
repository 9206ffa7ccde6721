"""Host utilities of the port: PNG I/O (``image``) and U-Net checkpoints
(``checkpoint``)."""
