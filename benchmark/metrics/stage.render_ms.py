"""stage.render_ms: the ms a frame of the step's ``render`` stage on the card
(the splat (S1, K2 and the image ops) or the march (R1, its loop and
branch nodes)), from the program's span ``render`` (marks at the stage's
entry and exit inside the captured graph); the mean over the window's
frames that the span ring holds."""
from benchmark.trace import span_ms


def read(run):
    return span_ms(run["spans"], "render")
