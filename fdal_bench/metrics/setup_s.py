"""Process start to the end of the warm solve (host clock)."""


def read(run):
    return run.setup_s
