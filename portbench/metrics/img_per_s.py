"""Images answered in the window over the window's length (host clock)."""


def read(run):
    return run.window.images / run.window.seconds
