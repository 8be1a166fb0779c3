"""loops.while_iters: the WHILE nodes' iterations a frame (the integrate
and render chunk loops), from the card's own counter of
``while_next_kernel`` read before and after the window."""


def read(run):
    c0, c1 = run["counts"]
    n = c1["graph_while_next"] - c0["graph_while_next"]
    return n / run["frames"] if n and run["frames"] else None
