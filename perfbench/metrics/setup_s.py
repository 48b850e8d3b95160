"""Process start to the start of the window, less the harness's own input
generation: imports, CUDA context, the program's kernel libraries, the service's
start, its warm-up and the mix's warm-up calls."""


def read(run):
    return run.setup_s
