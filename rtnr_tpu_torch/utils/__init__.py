"""Host utilities of the port: PNG I/O (``image``), U-Net checkpoints
(``checkpoint``) and tracing (``trace``)."""
