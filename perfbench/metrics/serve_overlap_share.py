"""The share, x100, of the window's `serve.decode` spans that start while
a `serve.decode` span of another thread is open: decodes whose group one
micro-batcher worker took and readied while the other's decode was in
flight."""

from perfbench import spans


def read(ctx, result, trace):
    decodes = [(s, tid, e) for n, tid, s, e in spans.window_spans(trace)
               or () if n == "serve.decode"]
    if not decodes:
        return None
    # a thread's decodes follow one another, so of each other thread's
    # only its latest started can be open
    latest_end, overlapped = {}, 0
    for s, tid, e in sorted(decodes):
        overlapped += any(end > s for t, end in latest_end.items()
                          if t != tid)
        latest_end[tid] = e
    return 100.0 * overlapped / len(decodes)
