"""setup_s: process start to the window's opening (rendering, extraction,
the map, kernel builds, warm-up and warm-up traffic)."""


def read(ctx):
    return ctx["setup_s"]
