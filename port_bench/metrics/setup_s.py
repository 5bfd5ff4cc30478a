"""Seconds from the process's start to the window's start: CUDA
initialisation, the kernel library (built at a checkout's first run,
loaded from its cache after), the beam made on the device, and one
warm pass of every plan step."""


def read(ctx):
    return ctx["setup_s"]
