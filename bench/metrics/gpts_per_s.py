"""Grid-point updates a second: points x steps of every call completed in
the window, over the window's seconds (host clock)."""


def read(run):
    return run.point_steps / run.window_s / 1e9
