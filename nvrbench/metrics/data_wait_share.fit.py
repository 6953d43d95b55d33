"""Host time blocked on the Prefetcher's queue over the window's wall time,
in % (``train/loop.py``'s ``EpochLog`` data wait, timed by the harness)."""


def read(r):
    if r.kind != "fit" or r.data_wait_s is None:
        return None
    return 100.0 * r.data_wait_s / r.window_s
