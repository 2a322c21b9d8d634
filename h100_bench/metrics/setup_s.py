"""setup_s: process start to the first timed unit (data, construction,
the kernel library built or loaded, graph capture, warm-up), host clock."""


def read(ctx):
    return ctx.setup_s
