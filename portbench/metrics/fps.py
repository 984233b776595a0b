"""fps: frame pairs whose scores reached the host in the window, over the
window's seconds (host clock)."""


def read(run):
    return run.frames / run.window_s
