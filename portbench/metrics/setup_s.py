"""setup_s: seconds from the process's start to the window's: the
generation of the library, the import of torch and the program, the
load (or first build) of its kernels, and one warm-up call."""


def read(run):
    return run.setup_s
