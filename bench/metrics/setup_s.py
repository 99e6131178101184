"""Set-up seconds: from the start of the process to the window's opening
(imports, weights, the engine, kernel builds and graph captures, and the
warm-up until the batch is full).  Host clock."""


def read(run):
    return run.setup_s
