"""``setup_s``: seconds from the start of the process to the first timed
call: imports, the card's start, the dataset made on the card, the engine,
its window norms (and factored responses where the route takes them), and
one warm-up call of the cell's own shapes."""


def read(win):
    return win.setup_s
