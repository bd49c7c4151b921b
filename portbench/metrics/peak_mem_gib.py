"""The most memory the program's tensors held on the device during the
window (``torch.cuda.max_memory_allocated``, reset at the window's start),
in GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
