"""Graph captures the serving module made inside the window (the increase
of `SynthesisModule.graphs.captures`): each is a stall in the queue."""


def read(ctx, result, trace):
    return result["counters"].get("captures")
