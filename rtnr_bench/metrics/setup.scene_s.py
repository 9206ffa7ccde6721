"""Seconds of the host clock around making the scene and weights and
building the program's state from them: ``Scene.from_arrays``, the
``Renderer`` (two ``sorted_by_block`` passes, the block index, the upload,
the U-Net's weight layout) or the training state and its feed."""


def read(run):
    return run.scene_s
