"""Queries completed in the window over the window's seconds (host clock;
every call ends in a synchronisation with the device)."""


def read(run):
    return run.queries / run.seconds
