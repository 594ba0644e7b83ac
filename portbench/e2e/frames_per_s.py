"""Frames of every completed request over the seconds from the window's
start to the last completion."""


def read(window):
    return sum(window.frames) / (window.last_end - window.start)
