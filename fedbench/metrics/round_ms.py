"""The window's elapsed time over the rounds completed in it; the window
ends at the first round completion after --seconds."""


def read(r):
    return 1e3 * r.window_s / r.rounds if r.rounds else None
