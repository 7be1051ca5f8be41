"""setup_s: from the start of the process to the window's opening: imports,
the CUDA context, the kernel library (built on a checkout's first run),
the frame pool and the warm-up clip."""


def read(run):
    return run.setup_s
