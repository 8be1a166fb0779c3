"""loops.while_iters: the WHILE nodes' iterations a frame, from the card's
own counter of ``while_next_kernel`` read before and after the window.
The integrate and the surfel z-buffer are single kernels and run no WHILE
node; what counts is the march render cache's loop
(``ops/render_cache.py``), or the splat's other sources and its polish
(``ops/splat.py``)."""


def read(run):
    c0, c1 = run["counts"]
    n = c1["graph_while_next"] - c0["graph_while_next"]
    return n / run["frames"] if n and run["frames"] else None
