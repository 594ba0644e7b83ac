"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the inputs, the program's set-up and warm-up."""


def read(window):
    return window.setup_s
