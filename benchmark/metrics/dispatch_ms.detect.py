"""Host time of one ``detect_frames_async`` call (upload and launches), the
mean over the window's batches, ms: the benchmark's own span around it."""


def read(ctx):
    if ctx["kind"] != "detect" or not ctx["run"]["dispatch_s"]:
        return None
    d = ctx["run"]["dispatch_s"]
    return 1e3 * sum(d) / len(d)
