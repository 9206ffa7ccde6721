"""Mean over the window's frames of the ``frame`` span less its own spans
(host clock, ms): the part of the frame no span covers, such as the pose
upload and the gaps between spans."""

from rtnr_bench import spans


def read(run):
    frames = spans.walk_frames(run)
    if not frames:
        return None
    own = [r["host_ms"] - sum(sp["host_ms"] for sp in spans.children(r)) for r in frames]
    return sum(own) / len(own)
