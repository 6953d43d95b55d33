"""Process start to the first timed step or frame."""


def read(r):
    return r.setup_s
