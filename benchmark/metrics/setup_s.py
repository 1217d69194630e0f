"""Set-up: from process start to the window's opening, in seconds."""

def read(rec, ctx):
    return ctx.setup_s
