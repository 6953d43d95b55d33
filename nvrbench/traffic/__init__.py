"""The traffic kinds: ``<kind>.py`` holds ``run(ctx)``, which sets up the
program for a cell, measures for ``--seconds`` and checks the outputs,
returning the readings the metric readers take."""
