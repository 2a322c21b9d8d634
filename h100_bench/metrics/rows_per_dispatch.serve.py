"""rows_per_dispatch.serve: the rows the traced open-loop window served
over the cudaGraphLaunch calls in the trace (one a dispatch)."""


def read(ctx):
    if ctx.trace is None or ctx.window.get("lat") is None:
        return None
    launches = ctx.trace.runtime_count("cudaGraphLaunch")
    return ctx.window["rows"] / launches if launches else None
