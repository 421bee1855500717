"""Mean host ms a request that ``InferenceSession.predict`` spends outside
its ``run`` call (checks, padding, copies, the noise draw, numpy out)."""


def read(ctx):
    return ctx["host_ms"] if ctx["kind"] == "serve" else None
