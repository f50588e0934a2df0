"""The program's kernel launches (its own counters, B1-B3) per call over
the window; nothing where it launched none (its plain versions)."""


def read(run):
    total = sum(run.window.launches.values())
    return total / run.window.calls if total and run.window.calls else None
