"""Set-up seconds: from the process's first statement to the window's
opening (the cell's inputs drawn, the program loaded and warmed)."""


def read(ctx):
    return ctx.setup_s
