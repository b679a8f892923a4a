"""setup_s: seconds from the process's start to the window's: imports,
the weights and traffic drawn, the program built (its kernels compiled on
a checkout's first run) and every shape warmed."""


def read(ctx):
    return ctx.setup_s
