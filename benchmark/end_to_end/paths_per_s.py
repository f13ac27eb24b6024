"""``paths_per_s``: every path the window generated over the window's
seconds (host clock; the window ends with the last task's return)."""


def read(win):
    return win.units / win.elapsed_s
