"""Seconds of audio out of the program in the window, every row (stream or
clip) of every call, over the window's wall seconds."""


def read(w):
    return w.calls * w.rows * w.block / w.sample_rate / w.window_s
