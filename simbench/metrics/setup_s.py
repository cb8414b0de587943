"""Seconds from the start of the benchmark's module through the end of the
warm-up: imports, the port's kernels loaded (or built by nvcc on a
checkout's first run), the batch's first episode set up and run for the
warm-up's rounds, every call the window makes made once."""


def read(w):
    return w.setup_s
