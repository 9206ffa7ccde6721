"""Mean over the window's frames of the culled compaction's kept points
over the scene's points (``Renderer._cull_cache``; 100 where the view
overflowed the budget and the whole cloud was drawn), in %."""


def read(run):
    if not run.frames:
        return None
    return 100.0 * sum(f["kept_share"] for f in run.frames) / len(run.frames)
