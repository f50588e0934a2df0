"""Host milliseconds a call into the program takes, from its start to its
return, the in-flight wait left out: the mean over the window's calls."""


def read(run):
    host = run.window.host_call_s
    return 1e3 * sum(host) / len(host) if host else None
