"""setup_s: process start to the first timed solve: imports, CUDA start,
the kernel library (built on a checkout's first run), the problem made on
the device and one warm-up solve."""


def read(run):
    return run.setup_s
