"""frame_ms: the whole window over the frames completed in it."""


def read(out, ctx):
    w = out.get("window")
    if not w or "frames" not in w:
        return None
    return 1e3 * w["seconds"] / w["frames"]
