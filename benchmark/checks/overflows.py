"""overflows: the volume's dropped allocations and visible-list entries
(``Pipeline.diagnostics``), held to the configuration's guarantee of
exactly 0.  A count of the program's own: no reference, no control."""
NUMBERS = ("overflows",)
FOLLOWS = {}


def read(pipe):
    return {"diagnostics": pipe.diagnostics()}


def numbers(inp, shared):
    d = inp.program["diagnostics"]
    return {"overflows": d["alloc_overflow"] + d["visible_overflow"]}


def control(inp, shared):
    return {}
