"""Complex samples of every capture (or segment) whose PDW dict came back
inside the window, over the window's seconds; the window closes when the
capture in flight at ``--seconds`` is back."""


def read(res):
    return res.samples / res.window_s / 1e6
