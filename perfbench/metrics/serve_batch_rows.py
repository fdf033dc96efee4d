"""Rows a coalesced decode in the window: the answered requests over the
decodes they shared, from the `batched` count the front end returns with
every request."""


def read(ctx, result, trace):
    c = result["counters"]
    if not c.get("decodes"):
        return None
    return (c["requests"] - result["failed"]) / c["decodes"]
