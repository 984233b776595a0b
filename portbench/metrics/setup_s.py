"""setup_s: from the process's start to the window's first batch (host
clock): imports, the device, the kernel library, the ring, the warm batches."""


def read(run):
    return run.setup_s
