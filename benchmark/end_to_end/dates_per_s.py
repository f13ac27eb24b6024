"""``dates_per_s``: every date backtested in the window over the window's
seconds (host clock; the window ends with the last call's return)."""


def read(win):
    return win.units / win.elapsed_s
