"""serve_rps: requests answered in the window over the window's length."""
from portbench import window


def read(ctx):
    w = ctx["window"]
    return window.rate(w["completed"], w["seconds"])
